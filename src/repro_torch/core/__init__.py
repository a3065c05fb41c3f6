"""SFC core in torch: exact algorithm generators, the tiled conv flow, the
error analysis (Table 1), the 2-D Hermitian generator and iterative SFC
(Appendix B)."""
from repro_torch.core import error_analysis, iterative, symbolic
from repro_torch.core.conv2d import (conv2d_direct, fastconv2d,
                                     inverse_transform_2d, pad_amounts,
                                     transform_domain_matmul,
                                     transform_input_2d, transform_matrices,
                                     transform_weights_2d)
from repro_torch.core.generator import (BilinearAlgorithm, direct_algorithm,
                                        generate_sfc, generate_winograd,
                                        paper_algorithms)
from repro_torch.core.generator2d import Bilinear2D, generate_sfc_2d_hermitian

__all__ = [
    "BilinearAlgorithm", "direct_algorithm", "generate_sfc",
    "generate_winograd", "paper_algorithms", "fastconv2d", "conv2d_direct",
    "pad_amounts", "transform_matrices", "transform_domain_matmul",
    "transform_input_2d", "transform_weights_2d", "inverse_transform_2d",
    "Bilinear2D", "generate_sfc_2d_hermitian",
    "error_analysis", "iterative", "symbolic",
]
