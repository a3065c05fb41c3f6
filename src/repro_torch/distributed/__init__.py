"""Distributed runtime: the sharding rules (``sharding``), the sharded
conv backend (``conv_spmd``, registered with ``repro_torch.api`` as
``"cuda_spmd"``), the activation rules (``act_sharding``), the sharded LM
train step (``lm_spmd``), the sharded serve and prefill steps
(``serve_spmd``) and the GPipe schedule (``pipeline``)."""
from repro_torch.distributed import conv_spmd, sharding

__all__ = ["conv_spmd", "sharding"]
