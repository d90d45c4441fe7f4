"""4-bit scalar quantization (counterpart of ``jvector_tpu/quantization/sq.py``).

Each dimension stores a 4-bit level ``k`` with the affine dequant
``v_m ~= a_m * k + b_m``, so every similarity factors into a multiply-reduce
over the raw code nibbles plus per-query and per-node constants (see
:class:`jvector_tpu_torch.graph.score.SQ4ScoreProvider`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jvector_tpu_torch.util.device import resolve_device

MAX_TRAINING_SET_SIZE = 131_072


def pack_nibble_rows(codes: torch.Tensor) -> torch.Tensor:
    """``[..., D]`` values <16 -> packed ``[..., D/2]`` uint8 (lo, hi)."""
    c = codes.to(torch.uint8)
    return c[..., 0::2] | (c[..., 1::2] << 4)


def unpack_nibble_rows(packed: torch.Tensor) -> torch.Tensor:
    """Packed ``[..., D/2]`` uint8 -> ``[..., D]`` int32 levels (interleaved)."""
    lo = (packed & 0xF).to(torch.int32)
    hi = (packed >> 4).to(torch.int32)
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)


def unpack_nibble_rows_grouped(packed: torch.Tensor) -> torch.Tensor:
    """Packed ``[..., D/2]`` uint8 -> ``[..., D]`` int32 levels in GROUPED
    order ``[even dims..., odd dims...]``; pair with :func:`group_dims`."""
    return torch.cat([packed & 0xF, packed >> 4], dim=-1).to(torch.int32)


def group_dims(u: torch.Tensor) -> torch.Tensor:
    """Permute the trailing dim to ``[even..., odd...]`` (grouped order)."""
    return torch.cat([u[..., 0::2], u[..., 1::2]], dim=-1)


def _quantile_lerp(sorted_x: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolated quantile of a column-sorted ``[n, D]`` tensor
    (numpy's default ``linear`` method)."""
    n = sorted_x.shape[0]
    pos = q * (n - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, n - 1)
    t = pos - lo
    a, b = sorted_x[lo], sorted_x[hi]
    return a + (b - a) * t


@dataclasses.dataclass(frozen=True)
class ScalarQuantization4:
    """Per-dim affine 4-bit quantizer: ``v ~= scale * k + offset``."""

    scale: torch.Tensor  # [D_pad] float32 (a_m)
    offset: torch.Tensor  # [D_pad] float32 (b_m)
    original_dim: int

    @staticmethod
    def compute(
        vectors: torch.Tensor | np.ndarray,
        clip_quantile: float = 0.001,
        seed: int = 0,
        device: torch.device | str | None = None,
    ) -> "ScalarQuantization4":
        """Fit per-dim clipped ranges on a <=128k uniform random sample.

        A numpy array is fitted on the host with ``np.quantile``, exactly as
        the JAX package fits host arrays, into tensors on ``device`` (default:
        the card); a tensor is sampled and fitted on its own device.  Pass
        the full corpus, never a prefix slice.
        """
        n, d = vectors.shape
        idx = None
        if n > MAX_TRAINING_SET_SIZE:
            idx = np.sort(
                np.random.default_rng(seed).choice(n, MAX_TRAINING_SET_SIZE, replace=False)
            )
        if isinstance(vectors, torch.Tensor):
            device = vectors.device
            sample = vectors if idx is None else vectors[torch.as_tensor(idx, device=vectors.device)]
            s = torch.sort(sample.float(), dim=0).values
            lo = _quantile_lerp(s, clip_quantile).cpu().numpy()
            hi = _quantile_lerp(s, 1.0 - clip_quantile).cpu().numpy()
        else:
            sample = np.asarray(vectors if idx is None else vectors[idx], np.float32)
            lo = np.quantile(sample, clip_quantile, axis=0)
            hi = np.quantile(sample, 1.0 - clip_quantile, axis=0)
            device = resolve_device(device)
        d_pad = ((d + 1) // 2) * 2
        # padded dims get scale 1 / offset 0: codes come out 0 and
        # contribute nothing to any measure
        scale = np.ones(d_pad, np.float32)
        offset = np.zeros(d_pad, np.float32)
        scale[:d] = np.maximum((hi - lo) / 15.0, 1e-12)
        offset[:d] = lo
        return ScalarQuantization4(
            scale=torch.as_tensor(scale, device=device),
            offset=torch.as_tensor(offset, device=device),
            original_dim=d,
        )

    @property
    def padded_dim(self) -> int:
        return self.scale.shape[0]

    @property
    def compressed_size(self) -> int:
        """Bytes per encoded vector (packed nibbles)."""
        return self.padded_dim // 2

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        if d < self.padded_dim:
            x = torch.nn.functional.pad(x, (0, self.padded_dim - d))
        return x

    def encode(self, vectors: torch.Tensor | np.ndarray, block: int = 262_144) -> torch.Tensor:
        """Encode to packed ``uint8 [N, D_pad/2]`` on the quantizer's device."""
        dev = self.scale.device
        outs = []
        for i in range(0, vectors.shape[0], block):
            x = self._pad(torch.as_tensor(vectors[i : i + block], dtype=torch.float32, device=dev))
            k = torch.clamp(torch.round((x - self.offset) / self.scale), 0, 15)
            outs.append(pack_nibble_rows(k))
        return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]

    def level_codebooks(self) -> torch.Tensor:
        """The quantizer viewed as PQ codebooks ``[D_pad, 16, 1]``: D
        subspaces of size 1 with 16 fixed affine levels ``a_m * k + b_m``, so
        SQ4 reuses the PQ machinery (the anisotropic descent) verbatim."""
        k = torch.arange(16, dtype=torch.float32, device=self.scale.device)
        return (self.scale[:, None] * k[None, :] + self.offset[:, None])[..., None]

    def encode_anisotropic(
        self, vectors: torch.Tensor | np.ndarray, threshold: float = 0.2, block: int = 65_536
    ) -> torch.Tensor:
        """Anisotropic SQ4 encoding (SCANN section 3.2 over scalar levels):
        the per-vector coordinate descent of ``pq.encode_anisotropic`` on
        :meth:`level_codebooks` (M = D_pad, K = 16, S = 1), which weights
        error parallel to the vector ``eta`` times more than perpendicular
        error.  For MIPS / dot-product corpora (BASELINE config 3).  Packed
        ``uint8 [N, D_pad/2]`` on the quantizer's device."""
        from jvector_tpu_torch.quantization.kmeans import compute_parallel_cost_multiplier
        from jvector_tpu_torch.quantization.pq import encode_anisotropic

        dev = self.scale.device
        eta = compute_parallel_cost_multiplier(threshold, vectors.shape[1])
        cbs = self.level_codebooks()
        outs = []
        for i in range(0, vectors.shape[0], block):
            x = self._pad(torch.as_tensor(vectors[i : i + block], dtype=torch.float32, device=dev))
            outs.append(pack_nibble_rows(encode_anisotropic(x, cbs, eta)))
        return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]

    def decode(self, packed: torch.Tensor) -> torch.Tensor:
        k = unpack_nibble_rows(packed).float()
        return (k * self.scale + self.offset)[..., : self.original_dim]

    def node_constants(self, packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-node scalars baked at encode time:

        - ``w2``:    ``sum_m (a_m k_m)^2``        (euclidean third term)
        - ``norm2``: ``sum_m (a_m k_m + b_m)^2``  (cosine denominator)
        """
        k = unpack_nibble_rows(packed).float()
        ak = k * self.scale
        w2 = torch.sum(ak * ak, dim=-1)
        v = ak + self.offset
        norm2 = torch.sum(v * v, dim=-1)
        return w2, norm2

    def reconstruction_error(self, vectors: torch.Tensor | np.ndarray) -> float:
        """Mean squared reconstruction error of the plain encode."""
        x = torch.as_tensor(vectors, dtype=torch.float32, device=self.scale.device)
        return float(torch.mean(torch.sum((self.decode(self.encode(x)) - x) ** 2, dim=1)))

    def provider_for_graph(self, codes_packed: torch.Tensor, neighbors: torch.Tensor, sim):
        """Full fused provider for a graph: builds the fused tables too.

        ``codes_packed`` must already be padded to the graph capacity.
        """
        from jvector_tpu_torch.graph.score import SQ4ScoreProvider, build_fused_sq4, sq4_aug_rows
        from jvector_tpu_torch.ops.similarity import SimilarityFunction

        sim = SimilarityFunction.parse(sim)
        w2, norm2 = self.node_constants(codes_packed)
        const = norm2 if sim == SimilarityFunction.COSINE else w2
        fused_packed, fused_w2 = build_fused_sq4(neighbors, codes_packed, const)
        return SQ4ScoreProvider(
            codes_packed=codes_packed,
            node_w2=w2,
            node_norm2=norm2,
            fused_packed=fused_packed,
            fused_w2=fused_w2,
            scale=self.scale,
            offset=self.offset,
            codes_aug=sq4_aug_rows(codes_packed, const),
            sim=sim,
        )
