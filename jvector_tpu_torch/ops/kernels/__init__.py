"""Hand-written CUDA kernels for Hopper (sources in ``jvector_tpu_torch/csrc``)
with their plain PyTorch twins.  Each wrapper launches its kernel for CUDA
tensors, runs its twin for CPU tensors, and counts its kernel launches in
its ``launches`` attribute."""

from jvector_tpu_torch.ops.kernels.adc import adc_score_kernel
from jvector_tpu_torch.ops.kernels.packed_adj import (
    packed_adj_only_update_inplace,
    packed_adj_only_update_ref,
    packed_adj_update_inplace,
    packed_adj_update_ref,
)
from jvector_tpu_torch.ops.kernels.scatter_rows import fused_update_inplace, fused_update_ref

__all__ = [
    "adc_score_kernel",
    "packed_adj_update_inplace",
    "packed_adj_update_ref",
    "packed_adj_only_update_inplace",
    "packed_adj_only_update_ref",
    "fused_update_inplace",
    "fused_update_ref",
]
