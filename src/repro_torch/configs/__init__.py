"""Model configurations of the port: the paper's evaluation CNNs."""
from repro_torch.configs.resnet18 import (CIFAR_RESNET18, RESNET18, SMOKE_CNN,
                                          VGG16, CNNConfig)

__all__ = ["CNNConfig", "RESNET18", "VGG16", "CIFAR_RESNET18", "SMOKE_CNN"]
