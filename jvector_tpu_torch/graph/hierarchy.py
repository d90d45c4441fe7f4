"""HNSW-style hierarchy on top of the Vamana base layer (counterpart of
``jvector_tpu/graph/hierarchy.py``).

Reference: ``GraphIndexBuilder.getRandomGraphLevel`` (geometric levels with
ml = 1/ln(maxDegree), rng seeded 0) and the sparse upper layers of
``OnHeapGraphIndex``; search descends the upper layers with beam 1.  As in
the JAX package, levels are drawn up front with numpy (so both packages
draw the same levels), each level is an ordinary wave build over its node
subset, and upper layers live in slot space (see ``GraphIndex``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def assign_levels(n: int, max_degree: int, seed: int = 0) -> np.ndarray:
    """Geometric level per node; P(level >= l) = (1/maxDegree)^l."""
    ml = 1.0 / np.log(max_degree)
    u = np.random.default_rng(seed).random(n)
    return np.floor(-np.log(np.maximum(u, 1e-300)) * ml).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class LevelProvider:
    """Scores slot-space ids of an upper layer through the base provider."""

    inner: object
    node_ids: torch.Tensor  # [n_l] slot -> base ordinal

    @property
    def exact(self) -> bool:
        return self.inner.exact

    def prepare(self, queries):
        return self.inner.prepare(queries)

    def score(self, qstate, slot_ids: torch.Tensor) -> torch.Tensor:
        return self.inner.score(qstate, self.node_ids[slot_ids.long()])


def slots_for(node_ids: torch.Tensor, base_ids: torch.Tensor) -> torch.Tensor:
    """Base ordinal -> slot in a sorted level id tensor (must be present)."""
    return torch.searchsorted(node_ids, base_ids).to(torch.int32)
