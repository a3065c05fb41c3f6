"""Launch layer: the device meshes the sharded backend runs over, the LM
serving launcher (``python -m repro_torch.launch.serve``) and the training
launcher (``python -m repro_torch.launch.train``)."""
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import (Mesh, make_forced_host_mesh,
                                     make_host_mesh)

__all__ = ["Mesh", "make_host_mesh", "make_forced_host_mesh", "serve",
           "train"]
