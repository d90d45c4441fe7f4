"""Product quantization (counterpart of ``jvector_tpu/quantization/pq.py``):
codebook training, encode / decode and the ADC score provider.

Reference: ``jv/quantization/ProductQuantization.java`` — ``compute()``
samples at most 128k vectors, optionally centers them globally and trains
a k-means per subspace (256 clusters by default).  As in the JAX package,
D is zero-padded to ``M * S`` so all subspaces train and encode with one
shape (padded dims add nothing to any measure), and codes are a dense
``uint8 [N, M]`` tensor.

The anisotropic variant (SCANN / AVQ, ``anisotropic_threshold > 0``) trains
with anisotropic k-means and encodes by per-vector coordinate descent
(:func:`encode_anisotropic`, ``encodeAnisotropic:269-347``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jvector_tpu_torch.ops.similarity import SimilarityFunction
from jvector_tpu_torch.quantization.kmeans import (
    assign_clusters,
    compute_parallel_cost_multiplier,
    kmeans,
    kmeans_anisotropic,
    lloyd,
)
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
    anisotropic_threshold: float = -1.0  # <= 0 -> plain PQ

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
        with ``seed``.  ``anisotropic_threshold > 0`` trains anisotropic
        k-means, its parallel-cost weight from the full dimension d."""
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
        if anisotropic_threshold > 0:
            eta = compute_parallel_cost_multiplier(anisotropic_threshold, d)
            codebooks = kmeans_anisotropic(sub, clusters, gen, eta, iters)
        else:
            codebooks = kmeans(sub, clusters, gen, iters)
        return ProductQuantization(codebooks=codebooks, center=center, original_dim=d,
                                   anisotropic_threshold=float(anisotropic_threshold))

    def refine(self, vectors: torch.Tensor | np.ndarray, iters: int = 6, seed: int = 1) -> "ProductQuantization":
        """Extra plain Lloyd rounds from the current codebooks on (new) data
        (reference ``ProductQuantization.refine:184-221``, compaction's
        ``PQRetrainer``); the <=128k sample is drawn as in :meth:`compute`."""
        n = vectors.shape[0]
        if n > MAX_TRAINING_SET_SIZE:
            idx = np.sort(np.random.default_rng(seed).choice(n, MAX_TRAINING_SET_SIZE, replace=False))
            vectors = vectors[torch.as_tensor(idx, device=vectors.device) if isinstance(vectors, torch.Tensor) else idx]
        x = _pad_to(torch.as_tensor(vectors, dtype=torch.float32, device=self.codebooks.device), self.padded_dim)
        if self.center is not None:
            x = x - self.center
        sub = x.reshape(-1, self.m, self.subspace_dim).transpose(0, 1).contiguous()
        return dataclasses.replace(self, codebooks=lloyd(sub, self.codebooks, iters))

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

    @property
    def compressed_size(self) -> int:
        """Bytes per encoded vector (``compressedVectorSize``)."""
        return self.m

    def encode(self, vectors: torch.Tensor | np.ndarray, block: int = 65_536) -> torch.Tensor:
        """Encode to ``uint8 [N, M]`` on the quantizer's device (nearest
        centroid per subspace, or the anisotropic descent).  Numpy input
        stays on the host until its block uploads; ``block`` bounds the
        ``[M, block, K]`` distance transient (the result does not depend on
        it).  The anisotropic encode keeps two ``[M, B, K]`` float32 tables,
        so its block is capped at ``(1 << 27) // (M * K)`` rows."""
        dev = self.codebooks.device
        if self.anisotropic_threshold > 0:
            block = min(block, max(1024, (1 << 27) // (self.m * self.clusters)))
        outs = []
        for i in range(0, vectors.shape[0], block):
            blk = torch.as_tensor(vectors[i : i + block], dtype=torch.float32, device=dev)
            outs.append(self._encode_block(blk))
        return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]

    def _encode_block(self, vectors: torch.Tensor) -> torch.Tensor:
        x = _pad_to(vectors, self.padded_dim)
        if self.center is not None:
            x = x - self.center
        if self.anisotropic_threshold > 0:
            eta = compute_parallel_cost_multiplier(self.anisotropic_threshold, self.original_dim)
            return encode_anisotropic(x, self.codebooks, eta)
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


def encode_anisotropic(x: torch.Tensor, codebooks: torch.Tensor, eta: float, max_sweeps: int = 10) -> torch.Tensor:
    """Per-vector anisotropic code optimization, batched over all vectors:
    x ``[N, M*S]`` (centered, padded), codebooks ``[M, K, S]`` -> ``uint8
    [N, M]``.

    Reference: ``ProductQuantization.encodeAnisotropic:269-347`` (SCANN
    section 3.2 coordinate descent).  Per (vector, subspace, centroid):
    ``rn2 = ||c - x_m||^2`` and ``lin = <c, x_m> - ||x_m||^2``; the parallel
    residual of the whole vector is ``(sum_m lin_m)^2 / ||x||^2`` and the
    cost ``eta * par + (||r||^2 - par)``.  Codes start at the plain L2
    argmin; each sweep walks the M subspaces in order and moves a
    subspace's code to the lowest-index centroid of least cost delta when
    that delta is below -1e-9.  The JAX package's signed form of the
    parallel term is kept (its docstring says why it departs from the
    reference's squared sum).

    The JAX package runs the ``max_sweeps * M`` dependent steps as one
    ``fori_loop``; here they are a host loop of small ops over subspace-major
    ``[M, N, K]`` tables, so each step reads one contiguous ``[N, K]`` slice.
    ``eta`` is rounded to float32, as the JAX package's traced scalar is.
    """
    m, k, s = codebooks.shape
    n = x.shape[0]
    eta = float(np.float32(eta))
    xs = x.reshape(n, m, s).transpose(0, 1)  # [M, N, S]
    cdotx = torch.bmm(xs, codebooks.transpose(1, 2))  # [M, N, K]
    xn2 = torch.sum(xs * xs, dim=2)  # [M, N]
    c2 = torch.sum(codebooks * codebooks, dim=2)[:, None, :]  # [M, 1, K]
    xnorm2 = torch.clamp(torch.sum(x * x, dim=1), min=1e-30)[:, None]  # [N, 1]
    rn2 = c2 - 2.0 * cdotx + xn2[:, :, None]  # [M, N, K]
    lin = cdotx - xn2[:, :, None]  # [M, N, K] signed <c - x_m, x_m>
    del cdotx
    codes = torch.argmin(rn2, dim=2)  # [M, N]
    total = torch.sum(torch.gather(lin, 2, codes[..., None])[..., 0], dim=0)  # [N]
    for i in range(max_sweeps * m):
        mi = i % m
        lin_m, rn2_m, old = lin[mi], rn2[mi], codes[mi]
        s_k = (total - torch.gather(lin_m, 1, old[:, None])[:, 0])[:, None] + lin_m  # [N, K]
        pnd = (torch.square(s_k) - torch.square(total)[:, None]) / xnorm2
        cost = eta * pnd + ((rn2_m - torch.gather(rn2_m, 1, old[:, None])) - pnd)
        best = torch.argmin(cost, dim=1)
        take = torch.gather(cost, 1, best[:, None])[:, 0] < -1e-9
        codes[mi] = torch.where(take, best, old)
        total = torch.where(take, torch.gather(s_k, 1, best[:, None])[:, 0], total)
    return codes.t().to(torch.uint8)
