"""Model zoo of the port: the paper's evaluation CNNs and the LM families
of the serving path (``dense``, ``ssm``, ``hybrid``)."""
from repro_torch.models import (attention, cnn, decode, layers, registry, ssm,
                                transformer)
from repro_torch.models.cnn import (VGG, ResNet, cnn_loss, init_resnet,
                                    init_vgg, resnet_forward, vgg_forward)
from repro_torch.models.registry import LM, Model, build

__all__ = ["cnn", "ResNet", "VGG", "init_resnet", "init_vgg",
           "resnet_forward", "vgg_forward", "cnn_loss",
           "attention", "decode", "layers", "registry", "ssm", "transformer",
           "LM", "Model", "build"]
