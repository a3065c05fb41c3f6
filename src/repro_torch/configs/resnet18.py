"""The paper's own evaluation CNNs (ResNet-18 family / VGG-16 family).

These drive the accuracy/BOPs benchmarks (paper Fig. 4, Tables 2/4/5) and
the end-to-end SFC training example.  ``CIFAR_RESNET18`` is the reduced
offline-trainable variant (synthetic/CIFAR-scale images).
"""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    stages: Tuple[int, ...]          # blocks per stage (resnet) / convs (vgg)
    widths: Tuple[int, ...]
    image_size: int
    n_classes: int
    kind: str = "resnet"             # resnet | vgg
    stem_kernel: int = 3
    # 'auto', 'direct', or any name in api.registry.list_algorithms()
    # (sfc6_7 / sfc6_6 / sfc4_4 / wino4 / wino2 / ... — the registry is
    # open, so downstream-registered algorithms are valid here too);
    # validated at construction so a typo'd config fails loudly instead
    # of silently training on the direct path
    conv_algo: str = "direct"
    quant: str = "none"              # none | int8 | int6 | int4
    act_granularity: str = "frequency"
    weight_granularity: str = "channel+frequency"

    def __post_init__(self):
        # late import: the registry pulls in the algorithm generators,
        # and configs must stay importable on their own
        from repro_torch.api.registry import list_algorithms
        valid = ("auto",) + list_algorithms()
        if self.conv_algo not in valid:
            raise ValueError(
                f"conv_algo={self.conv_algo!r} is not registered; "
                f"valid: {sorted(valid)}")


RESNET18 = CNNConfig(
    name="resnet18", stages=(2, 2, 2, 2), widths=(64, 128, 256, 512),
    image_size=224, n_classes=1000, stem_kernel=7)

VGG16 = CNNConfig(
    name="vgg16", kind="vgg", stages=(2, 2, 3, 3, 3),
    widths=(64, 128, 256, 512, 512), image_size=224, n_classes=1000)

# offline-trainable scale (the end-to-end example trains this from scratch)
CIFAR_RESNET18 = CNNConfig(
    name="cifar-resnet18", stages=(2, 2, 2, 2), widths=(32, 64, 128, 256),
    image_size=32, n_classes=10)

SMOKE_CNN = CNNConfig(
    name="smoke-cnn", stages=(1, 1), widths=(8, 16), image_size=16,
    n_classes=10)
