"""Model zoo of the port: the paper's evaluation CNNs and the LM families
of the serving path (``dense``, ``moe``, ``ssm``, ``hybrid``, ``vlm``,
``encdec``)."""
from repro_torch.models import (attention, cnn, decode, layers, mla, moe,
                                registry, ssm, transformer)
from repro_torch.models.cnn import (VGG, ResNet, cnn_loss, init_resnet,
                                    init_vgg, resnet_forward, vgg_forward)
from repro_torch.models.registry import LM, Model, build

__all__ = ["cnn", "ResNet", "VGG", "init_resnet", "init_vgg",
           "resnet_forward", "vgg_forward", "cnn_loss",
           "attention", "decode", "layers", "mla", "moe", "registry", "ssm",
           "transformer",
           "LM", "Model", "build"]
