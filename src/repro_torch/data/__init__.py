"""Deterministic synthetic data pipelines."""
from repro_torch.data.pipeline import (ImagePipelineConfig, Prefetcher,
                                       SyntheticImagePipeline,
                                       SyntheticTokenPipeline,
                                       TokenPipelineConfig)

__all__ = ["TokenPipelineConfig", "SyntheticTokenPipeline",
           "ImagePipelineConfig", "SyntheticImagePipeline", "Prefetcher"]
