"""Distributed runtime: the conv and batch sharding rules and the sharded
conv backend (``conv_spmd``, registered with ``repro_torch.api`` as
``"cuda_spmd"``)."""
from repro_torch.distributed import conv_spmd, sharding

__all__ = ["conv_spmd", "sharding"]
