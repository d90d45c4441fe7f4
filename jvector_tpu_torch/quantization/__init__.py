"""Quantization (PyTorch counterpart of ``jvector_tpu.quantization``): SQ4
and PQ."""

from jvector_tpu_torch.quantization.pq import ProductQuantization
from jvector_tpu_torch.quantization.sq import ScalarQuantization4

__all__ = ["ProductQuantization", "ScalarQuantization4"]
