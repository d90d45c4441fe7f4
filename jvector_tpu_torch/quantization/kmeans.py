"""k-means++ and Lloyd iterations, batched over PQ subspaces (counterpart of
``jvector_tpu/quantization/kmeans.py``).

Every function takes a leading batch dimension B (the PQ subspaces), where
the JAX package ``vmap``s single-subspace functions.  Draws come from a
``torch.Generator``: the JAX package's ``jax.random`` bits cannot be
reproduced, so codebooks agree with the JAX package's in quality, not bit
for bit.  The anisotropic variant is not ported.
"""

from __future__ import annotations

import torch

ASSIGN_BLOCK = 32_768  # rows per distance block: bounds the [B, n, k] transient


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
    b, n, d = data.shape
    centroids = kmeans_pp_init(data, k, generator)
    ones = torch.ones((b, n), dtype=data.dtype, device=data.device)
    for _ in range(iters):
        assign = assign_clusters(data, centroids)  # [B, n]
        sums = torch.zeros_like(centroids).scatter_add_(1, assign[:, :, None].expand(b, n, d), data)
        counts = torch.zeros((b, k), dtype=data.dtype, device=data.device).scatter_add_(1, assign, ones)
        new = sums / torch.clamp(counts, min=1.0)[:, :, None]
        centroids = torch.where(counts[:, :, None] > 0, new, centroids)
    return centroids
