"""Model zoo of the port: the paper's evaluation CNNs."""
from repro_torch.models import cnn
from repro_torch.models.cnn import (VGG, ResNet, cnn_loss, init_resnet,
                                    init_vgg, resnet_forward, vgg_forward)

__all__ = ["cnn", "ResNet", "VGG", "init_resnet", "init_vgg",
           "resnet_forward", "vgg_forward", "cnn_loss"]
