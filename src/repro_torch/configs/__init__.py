"""Model configurations of the port: the paper's evaluation CNNs and the
LM pool (``--arch <id>`` resolves here)."""
from repro_torch.configs import (deepseek_v3_671b, llama_3_2_vision_11b,
                                 mamba2_1_3b, mixtral_8x7b, phi4_mini_3_8b,
                                 qwen2_5_32b, qwen3_14b, stablelm_3b,
                                 whisper_tiny, zamba2_1_2b)
from repro_torch.configs.base import (SHAPES, SMOKE_SHAPE, ModelConfig,
                                      ShapeConfig, pad_vocab)
from repro_torch.configs.resnet18 import (CIFAR_RESNET18, RESNET18, SMOKE_CNN,
                                          VGG16, CNNConfig)

_MODULES = {
    "llama-3.2-vision-11b": llama_3_2_vision_11b,
    "qwen2.5-32b": qwen2_5_32b,
    "qwen3-14b": qwen3_14b,
    "stablelm-3b": stablelm_3b,
    "phi4-mini-3.8b": phi4_mini_3_8b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "mixtral-8x7b": mixtral_8x7b,
    "zamba2-1.2b": zamba2_1_2b,
    "mamba2-1.3b": mamba2_1_3b,
    "whisper-tiny": whisper_tiny,
}

ARCH_IDS = tuple(_MODULES)

# long_500k needs sub-quadratic attention: run only where the architecture
# is SSM, hybrid or sliding-window
LONG_CONTEXT_ARCHS = ("mamba2-1.3b", "zamba2-1.2b", "mixtral-8x7b")


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _MODULES[arch].SMOKE_CONFIG


def cells():
    """All (arch, shape) cells, with the long-context skips applied."""
    out = []
    for arch in ARCH_IDS:
        for sname, shape in SHAPES.items():
            if sname == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                continue
            out.append((arch, sname))
    return out


__all__ = ["CNNConfig", "RESNET18", "VGG16", "CIFAR_RESNET18", "SMOKE_CNN",
           "ModelConfig", "ShapeConfig", "SHAPES", "SMOKE_SHAPE", "pad_vocab",
           "ARCH_IDS", "LONG_CONTEXT_ARCHS", "get_config", "get_smoke_config",
           "cells"]
