"""Static analysis of the int8 datapath: overflow certificates
(``ranges``) and the launch checks of the ``cuda`` kernels'
geometries (``kernel_checks``)."""
