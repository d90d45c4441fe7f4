"""The JAX package's state, given as numpy arrays, turned into the port's.

Takes numpy (``np.asarray`` of the JAX arrays), never JAX arrays, so this
module imports no JAX: both packages can then serve the same graph with the
same quantizer and codes.  Every function puts its tensors on ``device``,
the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from jvector_tpu_torch.graph.index import GraphIndex, GraphLayer
from jvector_tpu_torch.graph.score import ExactScoreProvider, LUT16ScoreProvider, SQ4ScoreProvider
from jvector_tpu_torch.ops.similarity import SimilarityFunction
from jvector_tpu_torch.quantization.bq import BinaryQuantization
from jvector_tpu_torch.quantization.nvq import NVQuantization, NVQVectors
from jvector_tpu_torch.quantization.pq import ProductQuantization
from jvector_tpu_torch.quantization.sq import ScalarQuantization4
from jvector_tpu_torch.util.device import resolve_device

if TYPE_CHECKING:
    from jvector_tpu_torch.parallel import Mesh, ShardedIndex


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
    anisotropic_threshold: float = -1.0,
) -> ProductQuantization:
    """A trained PQ quantizer from its codebooks and centering vector (and
    its anisotropic threshold, which selects the anisotropic encode)."""
    device = resolve_device(device)
    return ProductQuantization(
        codebooks=torch.as_tensor(np.array(codebooks, np.float32), device=device),
        center=None if center is None else torch.as_tensor(np.array(center, np.float32), device=device),
        original_dim=int(original_dim),
        anisotropic_threshold=float(anisotropic_threshold),
    )


def bq_from_numpy(center: np.ndarray, original_dim: int, device: torch.device | str = "cuda") -> BinaryQuantization:
    """A BQ quantizer from its centroid ([D] float32)."""
    return BinaryQuantization(
        center=torch.as_tensor(np.array(center, np.float32), device=resolve_device(device)),
        original_dim=int(original_dim),
    )


def bq_codes_from_numpy(codes: np.ndarray, device: torch.device | str = "cuda") -> torch.Tensor:
    """The JAX package's packed BQ codes (``uint32 [N, W]``) as the port's
    int32 words, bit for bit."""
    return torch.as_tensor(np.array(codes, np.uint32).view(np.int32), device=resolve_device(device))


def nvq_from_numpy(
    mean: np.ndarray, original_dim: int, num_subvectors: int = 2, bits: int = 8, device: torch.device | str = "cuda"
) -> NVQuantization:
    """An NVQ quantizer from its global mean ([D] float32)."""
    return NVQuantization(
        mean=torch.as_tensor(np.array(mean, np.float32), device=resolve_device(device)),
        original_dim=int(original_dim),
        num_subvectors=int(num_subvectors),
        bits=int(bits),
    )


def nvq_vectors_from_numpy(codes: np.ndarray, params: np.ndarray, nvq: NVQuantization) -> NVQVectors:
    """NVQ-encoded vectors (codes ``uint8 [N, V, S]``, params float32
    ``[N, V, 4]``) on the device of ``nvq``."""
    dev = nvq.mean.device
    return NVQVectors(
        codes=torch.as_tensor(np.array(codes, np.uint8), device=dev),
        params=torch.as_tensor(np.array(params, np.float32), device=dev),
        nvq=nvq,
    )


def lut16_from_numpy(
    codes_packed: np.ndarray,  # uint8 [N, MP]
    fused_packed: np.ndarray | None,  # uint8 [N, MP, R] or None
    codebooks: np.ndarray,  # float32 [M, 16, S]
    center: np.ndarray | None,  # float32 [M*S] or None
    sim: SimilarityFunction | str,
    device: torch.device | str = "cuda",
) -> LUT16ScoreProvider:
    """A LUT16 (4-bit PQ) score provider from the JAX package's arrays."""
    device = resolve_device(device)

    def f32(x):
        return None if x is None else torch.as_tensor(np.array(x, np.float32), device=device)

    return LUT16ScoreProvider(
        codes_packed=codes_from_numpy(codes_packed, device),
        fused_packed=None if fused_packed is None else codes_from_numpy(fused_packed, device),
        codebooks=f32(codebooks),
        center=f32(center),
        sim=SimilarityFunction.parse(sim),
    )


def codes_from_numpy(codes: np.ndarray, device: torch.device | str = "cuda") -> torch.Tensor:
    """Quantized codes (packed SQ4 ``[N, D_pad/2]`` or PQ ``[N, M]``, uint8)."""
    return torch.as_tensor(np.array(codes, np.uint8), device=resolve_device(device))


_SQ4_PER_NODE = ("codes_packed", "node_w2", "node_norm2", "fused_packed", "fused_w2", "codes_aug")


def sharded_index_from_numpy(
    graphs: dict[str, np.ndarray],
    vectors: np.ndarray,  # float32 [S, n_local, D] the exact providers' vectors
    n_local: int,
    n_total: int,
    sim: SimilarityFunction | str,
    mesh: "Mesh",
    search_providers: dict[str, np.ndarray] | None = None,
) -> "ShardedIndex":
    """The JAX package's ``ShardedIndex``, its leaves as numpy arrays with a
    leading shard axis, as the port's on ``mesh`` (shard ``s`` on
    ``mesh.devices[s]``).

    ``graphs`` holds the base layer's ``neighbors`` / ``scores`` /
    ``counts`` and ``entry_node`` / ``num_nodes`` / ``deleted``;
    ``search_providers`` (None for an exact-only index) the SQ4 provider's
    fields, the per-node ones stacked and ``scale`` / ``offset`` shared.
    """
    from jvector_tpu_torch.parallel import ShardedIndex

    sim = SimilarityFunction.parse(sim)
    n_shards = vectors.shape[0]
    if n_shards != mesh.size:
        raise ValueError(f"{n_shards} shards, mesh has {mesh.size} devices")
    g, sp = {k: np.asarray(v) for k, v in graphs.items()}, search_providers
    gs, ps, sps = [], [], []
    for s, dev in enumerate(mesh.devices):
        gs.append(graph_from_numpy(g["neighbors"][s], g["scores"][s], g["counts"][s], int(g["entry_node"][s]),
                                   int(g["num_nodes"][s]), g["deleted"][s], device=dev))
        ps.append(ExactScoreProvider(vectors=torch.as_tensor(np.array(vectors[s], np.float32), device=dev), sim=sim))
        if sp is not None:
            sps.append(SQ4ScoreProvider(
                **{k: torch.as_tensor(np.array(sp[k][s]), device=dev) for k in _SQ4_PER_NODE},
                scale=torch.as_tensor(np.array(sp["scale"], np.float32), device=dev),
                offset=torch.as_tensor(np.array(sp["offset"], np.float32), device=dev),
                sim=sim,
            ))
    return ShardedIndex(graphs=gs, providers=ps, n_shards=n_shards, n_local=int(n_local), n_total=int(n_total),
                        search_providers=sps if sp is not None else None, sim=sim)
