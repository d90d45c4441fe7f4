"""Hand-written CUDA kernels for Hopper (sources in ``jvector_tpu_torch/csrc``)
with their plain PyTorch twins.  Each wrapper launches its kernel for CUDA
tensors, runs its twin for CPU tensors, and counts its kernel launches in
its ``launches`` attribute."""

from jvector_tpu_torch.ops.kernels.adc import adc_score_kernel
from jvector_tpu_torch.ops.kernels.adc16 import adc16_score_kernel
from jvector_tpu_torch.ops.kernels.frontier import frontier_filter, frontier_filter_ref
from jvector_tpu_torch.ops.kernels.packed_adj import (
    packed_adj_only_update_inplace,
    packed_adj_only_update_ref,
    packed_adj_update_inplace,
    packed_adj_update_ref,
)
from jvector_tpu_torch.ops.kernels.scatter_rows import (
    fused_update_inplace,
    fused_update_ref,
    scatter_rows3_inplace,
    scatter_rows_inplace,
    scatter_rows_ref,
    scatter_slots_inplace,
    scatter_slots_ref,
)

__all__ = [
    "adc_score_kernel",
    "adc16_score_kernel",
    "frontier_filter",
    "frontier_filter_ref",
    "packed_adj_update_inplace",
    "packed_adj_update_ref",
    "packed_adj_only_update_inplace",
    "packed_adj_only_update_ref",
    "fused_update_inplace",
    "fused_update_ref",
    "scatter_rows3_inplace",
    "scatter_rows_inplace",
    "scatter_rows_ref",
    "scatter_slots_inplace",
    "scatter_slots_ref",
]
