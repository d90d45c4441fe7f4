"""Binary quantization, 1 bit a dim (counterpart of
``jvector_tpu/quantization/bq.py``).

Reference: ``BinaryQuantization.java:88-110`` (sign bits around the dataset
centroid) and ``BQVectors`` hamming scoring.  Packing and scoring live in
:mod:`jvector_tpu_torch.ops.hamming`; codes are int32 words read bit for
bit as the JAX package's uint32 (``np.uint32`` only at the numpy edge:
:func:`codes_to_numpy`, ``convert.bq_codes_from_numpy``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jvector_tpu_torch.ops.hamming import pack_bits
from jvector_tpu_torch.util.device import resolve_device

ENCODE_BLOCK = 65_536  # rows packed at a time: bounds the [B, D] bool transient


def codes_to_numpy(codes: torch.Tensor) -> np.ndarray:
    """Packed codes as the JAX package's ``uint32`` words (files, features)."""
    return codes.detach().cpu().numpy().view(np.uint32)


@dataclasses.dataclass(frozen=True)
class BinaryQuantization:
    """Sign quantizer around the dataset centroid."""

    center: torch.Tensor  # [D] float32
    original_dim: int

    @staticmethod
    def compute(vectors: torch.Tensor | np.ndarray, device: torch.device | str | None = None) -> "BinaryQuantization":
        """The centroid of ``vectors`` on ``device`` (default: the tensor's
        device, or the card for numpy input)."""
        if device is None and isinstance(vectors, torch.Tensor):
            device = vectors.device
        x = torch.as_tensor(vectors, dtype=torch.float32, device=resolve_device(device))
        return BinaryQuantization(center=torch.mean(x, dim=0), original_dim=x.shape[1])

    @property
    def compressed_size(self) -> int:
        """Bytes per encoded vector."""
        return 4 * ((self.original_dim + 31) // 32)

    def encode(self, vectors: torch.Tensor | np.ndarray) -> torch.Tensor:
        """Sign bits of the centered vectors, packed into int32 words
        ``[N, ceil(D/32)]`` on the quantizer's device."""
        dev = self.center.device
        outs = [
            pack_bits(torch.as_tensor(vectors[i : i + ENCODE_BLOCK], dtype=torch.float32, device=dev) - self.center)
            for i in range(0, vectors.shape[0], ENCODE_BLOCK)
        ]
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    def provider(self, codes: torch.Tensor):
        from jvector_tpu_torch.graph.score import BQScoreProvider

        return BQScoreProvider(codes=codes, center=self.center, dim=self.original_dim)
