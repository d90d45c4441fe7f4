"""The JAX package's state, given as numpy arrays, turned into the port's.

Takes numpy (``np.asarray`` of the JAX arrays), never JAX arrays, so this
module imports no JAX: both packages can then serve the same graph with the
same quantizer and codes.  Every function puts its tensors on ``device``,
the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from jvector_tpu_torch.graph.index import GraphIndex, GraphLayer
from jvector_tpu_torch.quantization.pq import ProductQuantization
from jvector_tpu_torch.quantization.sq import ScalarQuantization4
from jvector_tpu_torch.util.device import resolve_device


def _layer(neighbors, scores, counts, device) -> GraphLayer:
    return GraphLayer(
        neighbors=torch.as_tensor(np.array(neighbors, np.int32), device=device),
        scores=torch.as_tensor(np.array(scores, np.float32), device=device),
        counts=torch.as_tensor(np.array(counts, np.int32), device=device),
    )


def graph_from_numpy(
    neighbors: np.ndarray,  # int32 [N_cap, R], -1 padded
    scores: np.ndarray,  # float32 [N_cap, R]
    counts: np.ndarray,  # int32 [N_cap]
    entry_node: int,
    num_nodes: int,
    deleted: np.ndarray | None = None,  # bool [N_cap]
    device: torch.device | str = "cuda",
    upper_layers: Sequence[tuple[np.ndarray, np.ndarray, np.ndarray]] = (),
    level_node_ids: Sequence[np.ndarray] = (),
) -> GraphIndex:
    """A graph on ``device``: the base layer, plus the hierarchy's upper
    layers as ``(neighbors, scores, counts)`` in slot space with their
    sorted base ordinals ``level_node_ids`` (one int32 array per level)."""
    device = resolve_device(device)
    if len(upper_layers) != len(level_node_ids):
        raise ValueError(f"{len(upper_layers)} upper layers but {len(level_node_ids)} level id arrays")
    if deleted is None:
        deleted = np.zeros(np.shape(neighbors)[0], bool)
    return GraphIndex(
        layers=tuple(_layer(*lay, device) for lay in [(neighbors, scores, counts), *upper_layers]),
        level_node_ids=tuple(torch.as_tensor(np.array(i, np.int32), device=device) for i in level_node_ids),
        entry_node=torch.tensor(int(entry_node), dtype=torch.int32, device=device),
        num_nodes=torch.tensor(int(num_nodes), dtype=torch.int32, device=device),
        deleted=torch.as_tensor(np.array(deleted, bool), device=device),
    )


def sq4_from_numpy(
    scale: np.ndarray, offset: np.ndarray, original_dim: int, device: torch.device | str = "cuda"
) -> ScalarQuantization4:
    """An SQ4 quantizer from its per-dim ``scale`` / ``offset`` ([D_pad] float32)."""
    device = resolve_device(device)
    return ScalarQuantization4(
        scale=torch.as_tensor(np.array(scale, np.float32), device=device),
        offset=torch.as_tensor(np.array(offset, np.float32), device=device),
        original_dim=int(original_dim),
    )


def pq_from_numpy(
    codebooks: np.ndarray,  # float32 [M, K, S]
    center: np.ndarray | None,  # float32 [M*S] or None
    original_dim: int,
    device: torch.device | str = "cuda",
) -> ProductQuantization:
    """A trained PQ quantizer from its codebooks and centering vector."""
    device = resolve_device(device)
    return ProductQuantization(
        codebooks=torch.as_tensor(np.array(codebooks, np.float32), device=device),
        center=None if center is None else torch.as_tensor(np.array(center, np.float32), device=device),
        original_dim=int(original_dim),
    )


def codes_from_numpy(codes: np.ndarray, device: torch.device | str = "cuda") -> torch.Tensor:
    """Quantized codes (packed SQ4 ``[N, D_pad/2]`` or PQ ``[N, M]``, uint8)."""
    return torch.as_tensor(np.array(codes, np.uint8), device=resolve_device(device))
