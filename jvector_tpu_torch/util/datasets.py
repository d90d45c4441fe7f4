"""Datasets: synthetic corpora with exact ground truth and the on-disk
loaders (counterpart of ``jvector_tpu/util/datasets.py``).

``synthetic_dataset`` and ``recall_at_k`` are numpy and give the same corpus
from the same seed as the JAX package; ``exact_ground_truth`` is a blocked
``torch.topk`` on the given device (the card unless the caller asks for the
CPU).  ``load_siftsmall``, ``load_hdf5`` and ``load_dataset`` read TEXMEX
fvecs triples and ann-benchmarks HDF5 files on the host.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from jvector_tpu_torch.ops.similarity import SimilarityFunction, pairwise_scores
from jvector_tpu_torch.util.device import resolve_device
from jvector_tpu_torch.util.io import read_fvecs, read_ivecs

# siftsmall's TEXMEX files, looked for inside the checkout
REFERENCE_SIFTSMALL_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "reference", "siftsmall"
)


@dataclasses.dataclass
class DataSet:
    """Base vectors + queries + ground truth."""

    name: str
    similarity: SimilarityFunction
    base: np.ndarray  # [N, D] float32
    queries: np.ndarray  # [Q, D] float32
    ground_truth: np.ndarray  # [Q, K] int32

    @property
    def dimension(self) -> int:
        return self.base.shape[1]


def exact_ground_truth(
    base: np.ndarray | torch.Tensor,
    queries: np.ndarray | torch.Tensor,
    k: int,
    sim: SimilarityFunction | str = SimilarityFunction.EUCLIDEAN,
    block: int = 200_000,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Brute-force top-k on ``device``, blocked over the base to bound memory."""
    sim = SimilarityFunction.parse(sim)
    device = resolve_device(device)
    q = torch.as_tensor(queries, dtype=torch.float32, device=device)
    best_scores = best_ids = None
    for start in range(0, base.shape[0], block):
        blk = torch.as_tensor(base[start : start + block], dtype=torch.float32, device=device)
        s, i = torch.topk(pairwise_scores(q, blk, sim), min(k, blk.shape[0]), dim=1)
        i = i + start
        if best_scores is not None:
            s = torch.cat([best_scores, s], dim=1)
            i = torch.cat([best_ids, i], dim=1)
            s, sel = torch.topk(s, k, dim=1)
            i = torch.gather(i, 1, sel)
        best_scores, best_ids = s, i
    return best_ids.to(torch.int32).cpu().numpy()


def synthetic_dataset(
    name: str = "synth-sift",
    n: int = 10_000,
    dim: int = 128,
    n_queries: int = 100,
    k: int = 100,
    sim: SimilarityFunction | str = SimilarityFunction.EUCLIDEAN,
    n_clusters: int = 64,
    seed: int = 0,
    latent_dim: int | None = None,
    device: torch.device | str = "cuda",
) -> DataSet:
    """Embedding-like clustered synthetic corpus with exact ground truth.

    A Gaussian mixture in a low-dimensional latent space projected up to
    ``dim`` with a small iid noise floor; same draws as the JAX package.
    The ground truth is computed on ``device``.
    """
    sim = SimilarityFunction.parse(sim)
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    ld = latent_dim or max(8, min(dim // 4, 32))
    proj = rng.normal(size=(ld, dim)).astype(np.float32)
    proj /= np.linalg.norm(proj, axis=1, keepdims=True)
    centers_z = rng.normal(0.0, 1.0, size=(n_clusters, ld)).astype(np.float32)

    def sample(count: int) -> np.ndarray:
        z = centers_z[rng.integers(0, n_clusters, size=count)] + rng.normal(
            0.0, 0.35, size=(count, ld)
        ).astype(np.float32)
        return (z @ proj + rng.normal(0.0, 0.03, size=(count, dim))).astype(np.float32)

    base = sample(n)
    queries = sample(n_queries)
    if sim != SimilarityFunction.EUCLIDEAN:
        base /= np.linalg.norm(base, axis=1, keepdims=True)
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    gt = exact_ground_truth(base, queries, k, sim, device=device)
    return DataSet(name=name, similarity=sim, base=base, queries=queries, ground_truth=gt)


def load_siftsmall(directory: str | None = None) -> DataSet | None:
    """The siftsmall set if its base vectors exist on disk, else None (the
    reference bundles only queries and ground truth, ``SiftSmall.java:387``);
    callers then fall back to :func:`synthetic_dataset`."""
    directory = directory or REFERENCE_SIFTSMALL_DIR
    base_path = os.path.join(directory, "siftsmall_base.fvecs")
    if not os.path.exists(base_path):
        return None
    return DataSet(
        name="siftsmall",
        similarity=SimilarityFunction.EUCLIDEAN,
        base=read_fvecs(base_path),
        queries=read_fvecs(os.path.join(directory, "siftsmall_query.fvecs")),
        ground_truth=read_ivecs(os.path.join(directory, "siftsmall_groundtruth.ivecs")).astype(np.int32),
    )


def load_hdf5(path: str | os.PathLike, name: str | None = None) -> DataSet:
    """An ann-benchmarks HDF5 dataset: ``train`` [N, D], ``test`` [Q, D],
    ``neighbors`` [Q, K], attribute ``distance`` (euclidean, angular /
    cosine, dot / ip).  Needs h5py, imported here."""
    import h5py

    with h5py.File(path, "r") as f:
        base = np.asarray(f["train"], np.float32)
        queries = np.asarray(f["test"], np.float32)
        gt = np.asarray(f["neighbors"], np.int32)
        dist = str(f.attrs.get("distance", "euclidean")).lower()
    sim = {
        "angular": SimilarityFunction.COSINE,
        "cosine": SimilarityFunction.COSINE,
        "dot": SimilarityFunction.DOT_PRODUCT,
        "ip": SimilarityFunction.DOT_PRODUCT,
    }.get(dist, SimilarityFunction.EUCLIDEAN)
    return DataSet(
        name=name or os.path.splitext(os.path.basename(str(path)))[0],
        similarity=sim,
        base=base,
        queries=queries,
        ground_truth=gt,
    )


def load_dataset(path_or_name: str) -> DataSet | None:
    """An ``.hdf5`` / ``.h5`` file, or a prefix ``X`` of ``X_base.fvecs`` /
    ``X_query.fvecs`` / ``X_groundtruth.ivecs`` (the TEXMEX convention);
    None when the files are absent."""
    if str(path_or_name).endswith((".hdf5", ".h5")):
        return load_hdf5(path_or_name) if os.path.exists(path_or_name) else None
    base_p = f"{path_or_name}_base.fvecs"
    if not os.path.exists(base_p):
        return None
    return DataSet(
        name=os.path.basename(str(path_or_name)),
        similarity=SimilarityFunction.EUCLIDEAN,
        base=read_fvecs(base_p),
        queries=read_fvecs(f"{path_or_name}_query.fvecs"),
        ground_truth=read_ivecs(f"{path_or_name}_groundtruth.ivecs").astype(np.int32),
    )


def recall_at_k(result_ids: np.ndarray, ground_truth: np.ndarray, k: int) -> float:
    """Mean recall@k (reference: ``AccuracyMetrics`` recall)."""
    hits = 0
    for row, gt in zip(result_ids[:, :k], ground_truth[:, :k]):
        hits += len(set(int(x) for x in row if x >= 0) & set(int(x) for x in gt))
    return hits / (result_ids.shape[0] * k)
