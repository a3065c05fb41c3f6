"""Launch layer: the device meshes the sharded backend runs over (and the
production mesh of H100s), the LM serving launcher (``python -m
repro_torch.launch.serve``), the training launcher (``python -m
repro_torch.launch.train``) and the dry run with its cost analysis
(``python -m repro_torch.launch.dryrun``, ``launch.dryrun_cnn``,
``launch.hlo_analysis``).  The launchers import on first use, so the
cost model can import the mesh's peaks without them."""
import importlib

from repro_torch.launch.mesh import (Mesh, make_forced_host_mesh,
                                     make_host_mesh, make_production_mesh)

_LAZY = ("serve", "train", "dryrun", "dryrun_cnn", "hlo_analysis")


def __getattr__(name: str):
    if name in _LAZY:
        return importlib.import_module(f"repro_torch.launch.{name}")
    raise AttributeError(name)


__all__ = ["Mesh", "make_host_mesh", "make_forced_host_mesh",
           "make_production_mesh", *_LAZY]
