"""SFC core in torch: exact algorithm generators and the tiled conv flow."""
from repro_torch.core import symbolic
from repro_torch.core.conv2d import (conv2d_direct, fastconv2d,
                                     inverse_transform_2d, pad_amounts,
                                     transform_domain_matmul,
                                     transform_input_2d, transform_matrices,
                                     transform_weights_2d)
from repro_torch.core.generator import (BilinearAlgorithm, direct_algorithm,
                                        generate_sfc, generate_winograd,
                                        paper_algorithms)

__all__ = [
    "BilinearAlgorithm", "direct_algorithm", "generate_sfc",
    "generate_winograd", "paper_algorithms", "fastconv2d", "conv2d_direct",
    "pad_amounts", "transform_matrices", "transform_domain_matmul",
    "transform_input_2d", "transform_weights_2d", "inverse_transform_2d",
    "symbolic",
]
