"""Graph index data model (counterpart of ``jvector_tpu/graph/index.py``).

A layer is a dense rectangle of tensors:

- ``neighbors: int32[N_cap, R]`` — neighbor ids, ``-1`` padded;
- ``scores: float32[N_cap, R]`` — edge similarity scores, ``-inf`` padded;
- ``counts: int32[N_cap]`` — live entries per row.

Rows are unique, score-sorted descending and padded with ``(-1, -inf)``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Build/search hyperparameters; the same fields and defaults as the
    JAX package's ``GraphConfig`` (see its comments for the measurements
    behind each default)."""

    max_degree: int = 32
    ef_construction: int = 100
    neighbor_overflow: float = 1.2
    alpha: float = 1.2
    row_slack: int = 16
    wave_size: int = 512
    add_hierarchy: bool = False
    max_build_iters: int = 400
    build_expand: int = 2
    build_compression: str | None = "sq4"
    prune_algo: str = "fixpoint"
    build_entry_seeds: int = 4
    build_repack_after: int = 0

    @property
    def overflow_degree(self) -> int:
        return int(self.max_degree * self.neighbor_overflow + 0.5)

    @property
    def row_cap(self) -> int:
        r = self.overflow_degree + self.row_slack
        return ((r + 7) // 8) * 8

    @property
    def alphas(self) -> tuple[float, ...]:
        """Alpha ramp 1.0 -> alpha in steps of 0.2 (``VamanaDiversityProvider.java:45-96``)."""
        out = []
        a = 1.0
        while a < self.alpha - 1e-6:
            out.append(round(a, 3))
            a += 0.2
        out.append(self.alpha)
        return tuple(out)


class GraphLayer(NamedTuple):
    """One adjacency level."""

    neighbors: torch.Tensor  # int32 [N_cap, R]
    scores: torch.Tensor  # float32 [N_cap, R]
    counts: torch.Tensor  # int32 [N_cap]


class GraphIndex(NamedTuple):
    """The index: base layer + HNSW-style upper levels.

    Upper layer ``l`` (``layers[l]``, l >= 1) is in *slot space*: its rows
    and neighbor ids are positions in ``level_node_ids[l - 1]``, the sorted
    base ordinals of the nodes on level ``l`` or above.  ``entry_node`` and
    ``num_nodes`` are 0-dim int32 tensors on the graph's device, so the
    build loop never waits on the device to read them.
    """

    layers: tuple[GraphLayer, ...]
    level_node_ids: tuple[torch.Tensor, ...]
    entry_node: torch.Tensor  # int32 scalar (base ordinal)
    num_nodes: torch.Tensor  # int32 scalar
    deleted: torch.Tensor  # bool [N_cap]

    @property
    def base(self) -> GraphLayer:
        return self.layers[0]

    @property
    def capacity(self) -> int:
        return self.layers[0].neighbors.shape[0]

    @property
    def row_cap(self) -> int:
        return self.layers[0].neighbors.shape[1]

    @property
    def num_levels(self) -> int:
        return len(self.layers)

    def average_degree(self) -> float:
        n = int(self.num_nodes)
        if n == 0:
            return 0.0
        return float(self.base.counts[:n].sum()) / n


def bucket_capacity(n: int, min_bucket: int = 256) -> int:
    """Round capacity up to a bucket (<=12.5% slack), as the JAX package
    does, so both packages size every table alike."""
    if n <= min_bucket:
        return min_bucket
    octave = 1 << ((n - 1).bit_length() - 1)  # largest power of two < n
    step = max(octave // 8, min_bucket)
    return ((n + step - 1) // step) * step


def empty_layer(capacity: int, row_cap: int, device: torch.device | str) -> GraphLayer:
    return GraphLayer(
        neighbors=torch.full((capacity, row_cap), -1, dtype=torch.int32, device=device),
        scores=torch.full((capacity, row_cap), NEG_INF, dtype=torch.float32, device=device),
        counts=torch.zeros((capacity,), dtype=torch.int32, device=device),
    )


def empty_graph(capacity: int, config: GraphConfig, device: torch.device | str) -> GraphIndex:
    """Allocate an empty single-level graph with the config's row capacity."""
    return GraphIndex(
        layers=(empty_layer(capacity, config.row_cap, device),),
        level_node_ids=(),
        entry_node=torch.tensor(-1, dtype=torch.int32, device=device),
        num_nodes=torch.tensor(0, dtype=torch.int32, device=device),
        deleted=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )
