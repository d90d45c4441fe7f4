"""NVQ: non-uniform per-vector 8-bit quantization (counterpart of
``jvector_tpu/quantization/nvq.py``).

Reference: ``NVQuantization.java`` — subtract the global mean, split each
vector into sub-vectors (2 by default) and store each sub-vector's 8-bit
codes under a learned logistic warp whose growth rate is found by a 1-D
grid search (a coarse integer sweep, then fine 0.1 steps,
``:524-578,677-702``); scoring dequantizes on the fly (``NVQScorer.java``).

As in the JAX package, every vector's candidate rates are evaluated at once
(one ``[n, V]`` loss a candidate), with no per-vector loop.  Where the JAX
package vmaps the candidates into one ``[21, n, V, S]`` tensor, this port
loops over them and blocks the rows, so only the ``[candidates, n, V]``
losses are kept whole.  Codes are ``uint8 [N, V, S]`` and per-(vector,
sub-vector) params ``{lo, scale, growth, midpoint}`` float32 ``[N, V, 4]``.

The warp: with ``t = (x - lo) / (hi - lo)`` in [0, 1],
``w(t) = (s(t) - s(0)) / (s(1) - s(0))`` where ``s(t) = 1/(1+exp(-a(t-m)))``;
``a -> 0`` recovers uniform quantization; code = round(255 * w).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jvector_tpu_torch.ops.similarity import SimilarityFunction
from jvector_tpu_torch.util.device import resolve_device

# growth-rate candidates: a = 0 (uniform) and 1..20, then best + the float32
# values of the JAX package's jnp.arange(-0.9, 0.91, 0.1) (np.arange with
# dtype float32 gives them bit for bit)
COARSE_RATES = np.concatenate([np.zeros(1, np.float32), np.arange(1.0, 21.0, dtype=np.float32)])
FINE_OFFSETS = np.arange(-0.9, 0.91, 0.1, dtype=np.float32)
_ENCODE_BLOCK = 16_384  # rows a sweep step: bounds the [B, V, S] transients
_UNWARP_HI = float(np.float32(1.0 - 1e-9))  # the JAX package's float32 clip: rounds to 1.0


def _linear(a: torch.Tensor) -> torch.Tensor:
    return torch.abs(a) < 1e-3


def _warp(t: torch.Tensor, a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Logistic warp normalized to [0, 1]; ``a`` ~ 0 degenerates to identity."""
    s0 = torch.sigmoid(a * (0.0 - m))
    s1 = torch.sigmoid(a * (1.0 - m))
    den = torch.clamp(s1 - s0, min=1e-12)
    return torch.where(_linear(a), t, (torch.sigmoid(a * (t - m)) - s0) / den)


def _unwarp(w: torch.Tensor, a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_warp` (logit)."""
    s0 = torch.sigmoid(a * (0.0 - m))
    s1 = torch.sigmoid(a * (1.0 - m))
    sv = torch.clamp(s0 + w * (s1 - s0), 1e-9, _UNWARP_HI)
    lin = _linear(a)
    t = m + torch.log(sv / (1.0 - sv)) / torch.where(lin, 1.0, a)
    return torch.where(lin, w, t)


@dataclasses.dataclass(frozen=True)
class NVQuantization:
    """NVQ trainer / encoder; stateless apart from the global mean."""

    mean: torch.Tensor  # [D] float32
    original_dim: int
    num_subvectors: int = 2
    bits: int = 8

    @staticmethod
    def compute(
        vectors: torch.Tensor | np.ndarray, num_subvectors: int = 2, device: torch.device | str | None = None
    ) -> "NVQuantization":
        """The global mean on ``device`` (default: the tensor's device, or
        the card for numpy input)."""
        if device is None and isinstance(vectors, torch.Tensor):
            device = vectors.device
        x = torch.as_tensor(vectors, dtype=torch.float32, device=resolve_device(device))
        return NVQuantization(mean=torch.mean(x, dim=0), original_dim=x.shape[1], num_subvectors=num_subvectors)

    @property
    def sub_dim(self) -> int:
        return -(-self.original_dim // self.num_subvectors)

    @property
    def padded_dim(self) -> int:
        return self.sub_dim * self.num_subvectors

    @property
    def levels(self) -> float:
        return float(2**self.bits - 1)

    def encode(self, vectors: torch.Tensor | np.ndarray) -> "NVQVectors":
        """Quantize on the quantizer's device: codes ``uint8 [N, V, S]`` +
        params ``[N, V, 4]``."""
        dev = self.mean.device
        n = vectors.shape[0]
        parts = [self._prepare(torch.as_tensor(vectors[i : i + _ENCODE_BLOCK], dtype=torch.float32, device=dev))
                 for i in range(0, n, _ENCODE_BLOCK)]
        coarse = torch.as_tensor(COARSE_RATES, device=dev)
        losses = torch.stack([self._loss(parts, torch.full((n, self.num_subvectors), float(a), device=dev))
                              for a in COARSE_RATES])  # [21, n, V]
        best = coarse[torch.argmin(losses, dim=0)]  # [n, V]
        fine = torch.as_tensor(FINE_OFFSETS, device=dev)
        losses = torch.stack([self._loss(parts, torch.clamp(best + fine[j], min=0.0))
                              for j in range(len(FINE_OFFSETS))])  # [19, n, V]
        growth = torch.clamp(best + fine[torch.argmin(losses, dim=0)], min=0.0)
        codes, params, start = [], [], 0
        for t, lo, scale, mid in parts:
            g = growth[start : start + t.shape[0]]
            start += t.shape[0]
            w = _warp(t, g[..., None], mid[..., None])
            codes.append(torch.round(w * self.levels).to(torch.uint8))
            params.append(torch.stack([lo, scale, g, mid], dim=-1))
        return NVQVectors(codes=torch.cat(codes), params=torch.cat(params), nvq=self)

    def _prepare(self, x: torch.Tensor):
        """One row block -> ``(t [B, V, S], lo, scale, midpoint [B, V])``."""
        x = x - self.mean
        if x.shape[1] < self.padded_dim:
            x = torch.nn.functional.pad(x, (0, self.padded_dim - x.shape[1]))
        xs = x.reshape(x.shape[0], self.num_subvectors, self.sub_dim)
        lo = torch.amin(xs, dim=2)
        scale = torch.clamp(torch.amax(xs, dim=2) - lo, min=1e-12)
        t = (xs - lo[..., None]) / scale[..., None]
        return t, lo, scale, torch.mean(t, dim=2)

    def _loss(self, parts, a: torch.Tensor) -> torch.Tensor:
        """Squared dequantization error of growth rates ``a [n, V]`` -> ``[n, V]``."""
        out, start = [], 0
        for t, _, _, mid in parts:
            ab = a[start : start + t.shape[0], :, None]
            start += t.shape[0]
            q = torch.round(_warp(t, ab, mid[..., None]) * self.levels) / self.levels
            out.append(torch.sum((_unwarp(q, ab, mid[..., None]) - t) ** 2, dim=2))
        return torch.cat(out)


@dataclasses.dataclass(frozen=True)
class NVQVectors:
    """Encoded NVQ corpus + scorer (reference ``NVQVectors`` / ``NVQScorer``)."""

    codes: torch.Tensor  # uint8 [N, V, S]
    params: torch.Tensor  # float32 [N, V, 4] = {lo, scale, growth, midpoint}
    nvq: NVQuantization

    @property
    def compressed_size(self) -> int:
        """Bytes per vector: codes + 4 float32 params per sub-vector."""
        v, s = self.codes.shape[1], self.codes.shape[2]
        return v * s + v * 16

    def dequantize(self, ids: torch.Tensor) -> torch.Tensor:
        """Reconstruct (mean-added) vectors for node ids ``[...]`` -> ``[..., D]``."""
        ids = ids.long()
        p = self.params[ids]  # [..., V, 4]
        t = _unwarp(self.codes[ids].float() / self.nvq.levels, p[..., 2:3], p[..., 3:4])
        xs = p[..., 0:1] + t * p[..., 1:2]
        flat = xs.reshape(*xs.shape[:-2], self.nvq.padded_dim)
        return flat[..., : self.nvq.original_dim] + self.nvq.mean

    def provider(self, sim: SimilarityFunction | str) -> "NVQScoreProvider":
        return NVQScoreProvider(vectors=self, sim=SimilarityFunction.parse(sim))

    # -- on-disk feature round trip (reference ``NVQ.java:36-110``: the
    #    NVQ_VECTORS feature stores codes + params inline) ------------------

    def feature_arrays(self) -> dict[str, np.ndarray]:
        """Arrays for ``write_index(features={FeatureId.NVQ_VECTORS: ...})``."""
        return {
            "codes": self.codes.cpu().numpy(),
            "params": self.params.cpu().numpy(),
            "mean": self.nvq.mean.cpu().numpy(),
            "dims": np.asarray([self.nvq.original_dim, self.nvq.num_subvectors, self.nvq.bits], np.int32),
        }

    @staticmethod
    def from_feature_arrays(arrays: dict, device: torch.device | str | None = None) -> "NVQVectors":
        """Rebuild from a loaded index's NVQ_VECTORS feature dict (numpy
        arrays, or tensors from ``OnDiskIndex.to_device``) on ``device``
        (default: the tensors' device, or the card for numpy)."""
        if device is None and isinstance(arrays["codes"], torch.Tensor):
            device = arrays["codes"].device
        device = resolve_device(device)

        def t(x, dtype):
            return torch.as_tensor(np.array(x.cpu() if isinstance(x, torch.Tensor) else x), dtype=dtype,
                                   device=device)

        dims = np.asarray(arrays["dims"].cpu() if isinstance(arrays["dims"], torch.Tensor) else arrays["dims"])
        nvq = NVQuantization(mean=t(arrays["mean"], torch.float32), original_dim=int(dims[0]),
                             num_subvectors=int(dims[1]), bits=int(dims[2]))
        return NVQVectors(codes=t(arrays["codes"], torch.uint8), params=t(arrays["params"], torch.float32), nvq=nvq)


@dataclasses.dataclass(frozen=True)
class NVQScoreProvider:
    """Scores queries against NVQ codes dequantized on the fly: the
    high-accuracy reranker (reference ``NVQ.rerankerFor``), usable as a
    primary provider.  ``score`` dequantizes ``[Q, R, D]`` whole (755 MB of
    float32 at 1024 queries, R = 120, D = 1536), so waves stay moderate."""

    vectors: NVQVectors
    sim: SimilarityFunction = SimilarityFunction.EUCLIDEAN

    @property
    def exact(self) -> bool:
        return True  # the "exact-class" tier, like the reference's NVQ rerank

    def prepare(self, queries: torch.Tensor) -> torch.Tensor:
        queries = queries.float()
        if self.sim == SimilarityFunction.COSINE:
            n = torch.sqrt(torch.sum(queries * queries, dim=-1, keepdim=True))
            return queries / torch.clamp(n, min=1e-30)
        return queries

    def score(self, qstate: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """qstate ``[Q, D]``, ids ``[Q, R]`` (>= 0) -> ``[Q, R]``."""
        from jvector_tpu_torch.graph.score import exact_score_rows

        return exact_score_rows(qstate, self.vectors.dequantize(ids), self.sim)
