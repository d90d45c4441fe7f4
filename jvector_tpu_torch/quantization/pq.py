"""Product quantization (counterpart of ``jvector_tpu/quantization/pq.py``):
codebook training, encode / decode and the ADC score provider.

Reference: ``jv/quantization/ProductQuantization.java`` — ``compute()``
samples at most 128k vectors, optionally centers them globally and trains
a k-means per subspace (256 clusters by default).  As in the JAX package,
D is zero-padded to ``M * S`` so all subspaces train and encode with one
shape (padded dims add nothing to any measure), and codes are a dense
``uint8 [N, M]`` tensor.

The anisotropic variant (``encodeAnisotropic``) is not ported: asking for
it raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jvector_tpu_torch.ops.similarity import SimilarityFunction
from jvector_tpu_torch.quantization.kmeans import assign_clusters, kmeans
from jvector_tpu_torch.util.device import resolve_device

MAX_TRAINING_SET_SIZE = 131_072  # reference MAX_PQ_TRAINING_SET_SIZE (128k)
DEFAULT_CLUSTERS = 256


def _pad_to(x: torch.Tensor, d_pad: int) -> torch.Tensor:
    d = x.shape[-1]
    return x if d == d_pad else torch.nn.functional.pad(x, (0, d_pad - d))


@dataclasses.dataclass(frozen=True)
class ProductQuantization:
    """Trained PQ: ``codebooks [M, K, S]`` + optional global centering vector."""

    codebooks: torch.Tensor  # [M, K, S] float32
    center: torch.Tensor | None  # [M*S] float32 or None
    original_dim: int

    @staticmethod
    def compute(
        vectors: torch.Tensor | np.ndarray,
        m: int,
        clusters: int = DEFAULT_CLUSTERS,
        globally_center: bool = True,
        anisotropic_threshold: float = -1.0,
        iters: int = 6,
        seed: int = 0,
        device: torch.device | str | None = None,
    ) -> "ProductQuantization":
        """Train codebooks (reference ``ProductQuantization.compute:109-139``)
        on ``device`` (default: the tensor's device, or the card for numpy
        input).  The <=128k sample is drawn with numpy from ``seed``, as in
        the JAX package; k-means++ draws from a ``torch.Generator`` seeded
        with ``seed``."""
        if anisotropic_threshold > 0:
            raise NotImplementedError("anisotropic PQ is not ported yet (ROADMAP.md queue 1 item 10)")
        if device is None and isinstance(vectors, torch.Tensor):
            device = vectors.device
        device = resolve_device(device)
        n, d = vectors.shape
        if n > MAX_TRAINING_SET_SIZE:
            idx = np.sort(np.random.default_rng(seed).choice(n, MAX_TRAINING_SET_SIZE, replace=False))
            if isinstance(vectors, torch.Tensor):
                vectors = vectors[torch.as_tensor(idx, device=vectors.device)]
            else:
                vectors = vectors[idx]
        sample = torch.as_tensor(vectors, dtype=torch.float32, device=device)
        s = -(-d // m)
        sample = _pad_to(sample, m * s)
        center = None
        if globally_center:
            center = torch.mean(sample, dim=0)
            sample = sample - center
        sub = sample.reshape(-1, m, s).transpose(0, 1).contiguous()  # [M, n, S]
        gen = torch.Generator(device=device).manual_seed(seed)
        return ProductQuantization(codebooks=kmeans(sub, clusters, gen, iters), center=center, original_dim=d)

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def clusters(self) -> int:
        return self.codebooks.shape[1]

    @property
    def subspace_dim(self) -> int:
        return self.codebooks.shape[2]

    @property
    def padded_dim(self) -> int:
        return self.m * self.subspace_dim

    def encode(self, vectors: torch.Tensor | np.ndarray, block: int = 65_536) -> torch.Tensor:
        """Encode to ``uint8 [N, M]`` on the quantizer's device (nearest
        centroid per subspace).  Numpy input stays on the host until its
        block uploads; ``block`` bounds the ``[M, block, K]`` distance
        transient (the result does not depend on it)."""
        dev = self.codebooks.device
        outs = []
        for i in range(0, vectors.shape[0], block):
            blk = torch.as_tensor(vectors[i : i + block], dtype=torch.float32, device=dev)
            outs.append(self._encode_block(blk))
        return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]

    def _encode_block(self, vectors: torch.Tensor) -> torch.Tensor:
        x = _pad_to(vectors, self.padded_dim)
        if self.center is not None:
            x = x - self.center
        sub = x.reshape(-1, self.m, self.subspace_dim).transpose(0, 1).contiguous()  # [M, n, S]
        return assign_clusters(sub, self.codebooks).t().to(torch.uint8)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """``[N, M]`` codes -> ``[N, original_dim]`` float32."""
        parts = self.codebooks[torch.arange(self.m, device=codes.device), codes.long()]  # [N, M, S]
        out = parts.reshape(codes.shape[0], -1)
        if self.center is not None:
            out = out + self.center
        return out[:, : self.original_dim]

    def reconstruction_error(self, vectors: torch.Tensor | np.ndarray) -> float:
        """Mean squared reconstruction error (``VectorCompressor.reconstructionError``)."""
        x = torch.as_tensor(vectors, dtype=torch.float32, device=self.codebooks.device)
        dec = self.decode(self.encode(x))
        return float(torch.mean(torch.sum((dec - x) ** 2, dim=1)))

    def provider(self, codes: torch.Tensor, sim: SimilarityFunction | str):
        """The ``CompressedVectors.precomputedScoreFunctionFor`` equivalent."""
        from jvector_tpu_torch.graph.score import ADCScoreProvider

        return ADCScoreProvider(
            codes=codes, codebooks=self.codebooks, center=self.center, sim=SimilarityFunction.parse(sim)
        )
