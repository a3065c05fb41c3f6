"""``test_torch_lm_grads.py``'s gradient check (the port's LM loss
gradients against ``jax.grad`` of the JAX package's, each leaf within 1e-4
rel L2) for the moe, vlm and encdec families: deepseek-v3 (MLA, the MoE,
the MTP term), mixtral-8x7b, llama-3.2-vision-11b (gates 0.5 and -0.7)
and whisper-tiny."""
import pytest

pytest.importorskip("torch")

from test_torch_lm_grads import (FAMILIES, _isolated,  # noqa: E402,F401
                                 _one_thread, archs,
                                 loss_gradients_match_jax)


@pytest.mark.parametrize("arch", archs(FAMILIES))
def test_loss_gradients_match_jax(arch):
    loss_gradients_match_jax(arch)
