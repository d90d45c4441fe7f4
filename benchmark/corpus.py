"""The configuration's dataset, made as its source makes it.

A frozen copy of ann-benchmarks' ``random_float`` datasets
(``random-s-100-euclidean``, ``random-s-100-angular``): scikit-learn's
``make_blobs`` (``n_samples`` points in ``n_features`` dimensions around
``centers`` centers drawn uniformly from ``center_box``, each point
``center + cluster_std * N(0, I)``, then shuffled; ``random_state`` fixed),
split by ``train_test_split`` into a base and ``test_size`` queries.
ann-benchmarks draws that split afresh; here it is drawn from
``split_random_state``, so every run serves the same base and the same
queries.  Both steps are replayed with numpy's ``RandomState`` call for
call, so the arrays equal scikit-learn's (``benchmark/tests`` holds them
to values that scikit-learn gave).  ``normalize`` scales every vector to
unit length, as a cosine deployment stores them.

Nothing here imports the port; the benchmark hands these tensors to the
port and to the reference alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Corpus:
    base: torch.Tensor  # float32 [n, dim]
    queries: torch.Tensor  # float32 [n_queries, dim]


def make_blobs(n_samples: int, n_features: int, centers: int, cluster_std: float, center_box: list,
               random_state: int) -> np.ndarray:
    """scikit-learn's ``make_blobs(..., shuffle=True)``, its points only."""
    rng = np.random.RandomState(random_state)
    c = rng.uniform(center_box[0], center_box[1], size=(centers, n_features))
    per = [n_samples // centers + (i < n_samples % centers) for i in range(centers)]
    x = np.concatenate([rng.normal(loc=c[i], scale=cluster_std, size=(k, n_features)) for i, k in enumerate(per)])
    order = np.arange(n_samples)
    rng.shuffle(order)
    return x[order]


def split(n_samples: int, test_size: int, random_state: int) -> tuple[np.ndarray, np.ndarray]:
    """scikit-learn's ``train_test_split`` rows: (train, test) indices."""
    perm = np.random.RandomState(random_state).permutation(n_samples)
    return perm[test_size:], perm[:test_size]


def make(cfg: dict, device: torch.device) -> Corpus:
    """The configuration's base (``cfg["n"]`` x ``cfg["dim"]``) and its
    ``cfg["queries"]`` queries, float32 on ``device``."""
    d = cfg["dataset"]
    x = make_blobs(d["n_samples"], d["n_features"], d["centers"], d["cluster_std"], d["center_box"], d["random_state"])
    train, test = split(d["n_samples"], d["test_size"], d["split_random_state"])
    base = torch.from_numpy(x[train].astype(np.float32)).to(device)
    queries = torch.from_numpy(x[test].astype(np.float32)).to(device)
    if d["normalize"]:
        base /= torch.linalg.vector_norm(base, dim=1, keepdim=True)
        queries /= torch.linalg.vector_norm(queries, dim=1, keepdim=True)
    if base.shape != (cfg["n"], cfg["dim"]) or queries.shape[0] != cfg["queries"]:
        raise ValueError(f"dataset gives {tuple(base.shape)} and {queries.shape[0]} queries; "
                         f"the configuration states {cfg['n']} x {cfg['dim']} and {cfg['queries']}")
    return Corpus(base=base, queries=queries)
