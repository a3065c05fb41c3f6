"""Launch layer: the device meshes the sharded backend runs over."""
from repro_torch.launch.mesh import (Mesh, make_forced_host_mesh,
                                     make_host_mesh)

__all__ = ["Mesh", "make_host_mesh", "make_forced_host_mesh"]
