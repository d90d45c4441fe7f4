"""k-means++ and Lloyd iterations, batched over PQ subspaces (counterpart of
``jvector_tpu/quantization/kmeans.py``).

Every function takes a leading batch dimension B (the PQ subspaces), where
the JAX package ``vmap``s single-subspace functions.  Draws come from a
``torch.Generator``: the JAX package's ``jax.random`` bits cannot be
reproduced, so codebooks agree with the JAX package's in quality, not bit
for bit.  The Lloyd rounds are split out (:func:`lloyd`,
:func:`lloyd_anisotropic`), so they can start from any centroids, the JAX
package's k-means++ seeds among them.
"""

from __future__ import annotations

import numpy as np
import torch

ASSIGN_BLOCK = 32_768  # rows per distance block: bounds the [B, n, k] transient
OUTER_BLOCK = 1 << 25  # elements of the anisotropic update's [B, rows, d, d] outer products


def _sq_dists(data: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """``[B, n, d]`` x ``[B, k, d]`` -> ``[B, n, k]`` squared distances via the
    matmul expansion."""
    d2 = (
        torch.sum(data * data, dim=-1)[:, :, None]
        + torch.sum(centroids * centroids, dim=-1)[:, None, :]
        - 2.0 * torch.bmm(data, centroids.transpose(1, 2))
    )
    return torch.clamp(d2, min=0.0)


def assign_clusters(data: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment ``[B, n]`` int64 (the encode step), the
    lowest index among equal distances, in row blocks."""
    out = [
        torch.argmin(_sq_dists(data[:, i : i + ASSIGN_BLOCK], centroids), dim=-1)
        for i in range(0, data.shape[1], ASSIGN_BLOCK)
    ]
    return torch.cat(out, dim=1) if len(out) > 1 else out[0]


def kmeans_pp_init(data: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """D^2-weighted k-means++ seeding (``KMeansPlusPlusClusterer.java:171-226``):
    data ``[B, n, d]`` -> centroids ``[B, k, d]``."""
    b, n, d = data.shape
    dev = data.device
    rows = torch.arange(b, device=dev)
    first = torch.randint(0, n, (b,), generator=generator, device=dev)
    centroids = torch.zeros((b, k, d), dtype=data.dtype, device=dev)
    centroids[:, 0] = data[rows, first]
    min_d2 = torch.sum((data - data[rows, first][:, None, :]) ** 2, dim=-1)  # [B, n]
    for i in range(1, k):
        # sample proportional to min_d2; uniformly when all mass is zero
        w = torch.where((min_d2 > 0).any(dim=1, keepdim=True), torch.clamp(min_d2, min=0.0), 1.0)
        idx = torch.multinomial(w, 1, generator=generator)[:, 0]
        c = data[rows, idx]  # [B, d]
        centroids[:, i] = c
        min_d2 = torch.minimum(min_d2, torch.sum((data - c[:, None, :]) ** 2, dim=-1))
    return centroids


def kmeans(data: torch.Tensor, k: int, generator: torch.Generator, iters: int = 6) -> torch.Tensor:
    """k-means++ init + ``iters`` Lloyd rounds: data ``[B, n, d]`` ->
    centroids ``[B, k, d]``.  Empty clusters keep their previous centroid."""
    return lloyd(data, kmeans_pp_init(data, k, generator), iters)


def _segment_sum(values: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[s] = sum of values[i] where seg[i] == s``, each segment's rows
    added one after another in row order: a stable sort groups the rows,
    ``torch.segment_reduce`` sums each group (one sequential sum per output
    element on the card, no atomics).  Empty segments give 0."""
    order = torch.sort(seg, stable=True).indices
    lengths = torch.bincount(seg, minlength=num_segments)
    return torch.segment_reduce(values[order], "sum", lengths=lengths)


def lloyd(data: torch.Tensor, centroids: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` plain Lloyd rounds from ``centroids [B, k, d]`` (also
    ``ProductQuantization.refine``'s)."""
    b, n, d = data.shape
    k = centroids.shape[1]
    seg_base = (torch.arange(b, device=data.device) * k)[:, None]
    flat = data.reshape(b * n, d)
    for _ in range(iters):
        seg = (assign_clusters(data, centroids) + seg_base).reshape(-1)  # [B*n]
        sums = _segment_sum(flat, seg, b * k).reshape(b, k, d)
        counts = torch.bincount(seg, minlength=b * k).to(data.dtype).reshape(b, k)
        new = sums / torch.clamp(counts, min=1.0)[:, :, None]
        centroids = torch.where(counts[:, :, None] > 0, new, centroids)
    return centroids


# ---------------------------------------------------------------------------
# Anisotropic (SCANN / AVQ) variant
# ---------------------------------------------------------------------------


def compute_parallel_cost_multiplier(threshold: float, dim: int) -> float:
    """Reference ``KMeansPlusPlusClusterer.computeParallelCostMultiplier:116-124``:
    the anisotropic threshold T as the weight eta on parallel residual error
    (SCANN eq. 9 with squared threshold).  ``dim`` is the full vector
    dimension, not a subspace's."""
    t2 = threshold * threshold
    return float((dim - 1.0) * t2 / max(1.0 - t2, 1e-12))


def _anisotropic_cost(data: torch.Tensor, x_norm2: torch.Tensor, centroids: torch.Tensor, eta: float) -> torch.Tensor:
    """``eta * ||r_par||^2 + ||r_perp||^2`` for ``r = x - c`` split along x:
    data ``[B, n, d]``, x_norm2 ``[B, n]`` -> ``[B, n, k]``."""
    dots_xc = torch.bmm(data, centroids.transpose(1, 2))
    xn = x_norm2[:, :, None]
    par = (xn - dots_xc) ** 2 / xn  # (x.(x - c))^2 / |x|^2
    r2 = xn + torch.sum(centroids * centroids, dim=-1)[:, None, :] - 2.0 * dots_xc
    return eta * par + torch.clamp(r2 - par, min=0.0)


def assign_clusters_anisotropic(data: torch.Tensor, centroids: torch.Tensor, eta: float) -> torch.Tensor:
    """Anisotropic assignment ``[B, n]`` int64 (``KMeansPlusPlusClusterer.java:278-324``),
    the lowest index among equal costs, in row blocks."""
    x_norm2 = torch.clamp(torch.sum(data * data, dim=-1), min=1e-12)
    out = [
        torch.argmin(_anisotropic_cost(data[:, i : i + ASSIGN_BLOCK], x_norm2[:, i : i + ASSIGN_BLOCK], centroids, eta),
                     dim=-1)
        for i in range(0, data.shape[1], ASSIGN_BLOCK)
    ]
    return torch.cat(out, dim=1) if len(out) > 1 else out[0]


def lloyd_anisotropic(data: torch.Tensor, centroids: torch.Tensor, eta: float, iters: int) -> torch.Tensor:
    """``iters`` anisotropic Lloyd rounds from ``centroids [B, k, d]``.

    Update (``KMeansPlusPlusClusterer.java:378-431``, AVQ appendix 7.5):
    each centroid solves ``(sum_i (eta - 1) x_i x_i^T / ||x_i||^2 + count I
    + 1e-6 I) c = eta * sum_i x_i`` over its points.  The per-cluster outer
    products are summed with :func:`_segment_sum`, a block of rows at a
    time, the blocks in order; a cluster with no points keeps its centroid.  ``eta`` is rounded to
    float32 first, as the JAX package's traced scalar is, so ``eta - 1``
    rounds alike."""
    b, n, d = data.shape
    k = centroids.shape[1]
    dev = data.device
    eta = float(np.float32(eta))
    x_norm2 = torch.clamp(torch.sum(data * data, dim=-1), min=1e-12)  # [B, n]
    xs = data * ((eta - 1.0) / x_norm2)[..., None]
    seg_base = (torch.arange(b, device=dev) * k)[:, None]
    eye = torch.eye(d, dtype=data.dtype, device=dev)
    rows = max(1, OUTER_BLOCK // (b * d * d))  # rows a block: bounds the [B, rows, d, d] products
    for _ in range(iters):
        seg = assign_clusters_anisotropic(data, centroids, eta) + seg_base  # [B, n]
        outer = torch.zeros((b * k, d, d), dtype=data.dtype, device=dev)
        for i in range(0, n, rows):
            prod = xs[:, i : i + rows, :, None] * data[:, i : i + rows, None, :]
            outer += _segment_sum(prod.reshape(-1, d, d), seg[:, i : i + rows].reshape(-1), b * k)
        seg = seg.reshape(-1)
        sums = _segment_sum(data.reshape(b * n, d), seg, b * k)
        counts = torch.bincount(seg, minlength=b * k).to(data.dtype)
        a = outer + counts[:, None, None] * eye
        new = torch.linalg.solve(a + 1e-6 * eye, (eta * sums)[..., None])[..., 0].reshape(b, k, d)
        centroids = torch.where((counts > 0).reshape(b, k, 1), new, centroids)
    return centroids


def kmeans_anisotropic(
    data: torch.Tensor, k: int, generator: torch.Generator, eta: float, iters: int = 6
) -> torch.Tensor:
    """k-means++ init + ``iters`` anisotropic Lloyd rounds: data ``[B, n, d]``
    (residual-space training vectors) -> centroids ``[B, k, d]``."""
    return lloyd_anisotropic(data, kmeans_pp_init(data, k, generator), eta, iters)
