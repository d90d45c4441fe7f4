"""Larger-than-memory (LTM) index construction (counterpart of
``jvector_tpu/disk/ltm.py``).

Reference: tutorial 3 / ``SiftSmall.siftDiskAnnLTM`` and ``Grid.buildOnDisk``:
compressed codes are the only full-corpus working set on the device; the
full-resolution vectors visit it one wave at a time and land in a reserved
extent of the output file.  The graph is built with the ordinary wave
insert, the wave's vectors acting as the queries.

``compression="pq"`` builds on PQ-ADC scores (K5).  ``compression="sq4"``
builds on 4-bit codes in one of three regimes, chosen as in the JAX package:

- **fused** (the fused code table fits ``_FUSED_BUILD_BUDGET``): the unpacked
  graph beside fused tables kept slot-exact by K2;
- **packed** (past the budget, on packed-eligible shapes; the 10M/100M
  regime): the ``[N/8, 8, 128]`` packed adjacency, pruned on the SQ4 codes
  themselves and written in place by K3 (:func:`_wave_apply_adj_only`),
  then ``packed_cleanup`` and a host round trip to the ``[N, R]`` layout;
- **plain**: plain code-row searches (:func:`_insert_wave`).

The saved SQ4 index carries the fused-SQ4 feature, so
:class:`jvector_tpu_torch.disk.host_graph.HostGraphIndex` serves it with
bounded device memory.  ``checkpoint_every`` persists the build state to
``path + ".ckpt"``; the same call resumes there, bit-identical to an
uninterrupted build.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable

import numpy as np
import torch

from jvector_tpu_torch.disk.format import FeatureId, IndexFileReader, IndexFileWriter, _np, _read_l0_neighbors
from jvector_tpu_torch.graph.builder import (
    GraphIndexBuilder,
    _drop_sink,
    _EntrySeedSampler,
    _empty_packed_adjacency,
    _fused_aligned_config,
    _insert_wave,
    _packed_adj_eligible,
    _phase_timer,
    _shuffled_wave_starts,
    _sink_graph,
    _wave_apply_adj_only,
    _wave_search,
    _wave_update_compute,
    _wave_update_fused,
    packed_cleanup,
)
from jvector_tpu_torch.graph.hierarchy import assign_levels
from jvector_tpu_torch.graph.index import NEG_INF, GraphConfig, GraphIndex, GraphLayer, bucket_capacity
from jvector_tpu_torch.graph.score import (
    ADCScoreProvider,
    SQ4ScoreProvider,
    build_fused_sq4,
    build_fused_sq4_host,
    sq4_aug_rows,
)
from jvector_tpu_torch.ops.similarity import SimilarityFunction
from jvector_tpu_torch.quantization.pq import ProductQuantization
from jvector_tpu_torch.quantization.sq import ScalarQuantization4
from jvector_tpu_torch.util.device import resolve_device

log = logging.getLogger(__name__)

# device-memory budget of the incremental fused table during SQ4 builds;
# past it the build takes the packed (or plain) regime.  Module-level so
# tests can force a regime at small n.
_FUSED_BUILD_BUDGET = 6 << 30

# fused-table budget of the saved index's device-resident serving tier; past
# it the save streams the fused layout into the file from the host and
# returns a fused-less provider (serving goes through HostGraphIndex)
_FUSED_SERVE_BUDGET = 4 << 30

_SAMPLE_STEP = 262_144  # rows per loader call when gathering samples


def _add_array_chunked(writer: IndexFileWriter, name: str, arr, dtype, max_bytes: int = 256 << 20) -> None:
    """Stream a tensor (or array) into the file in bounded row chunks, so a
    multi-GB device array never lands on the host whole."""
    dt = np.dtype(dtype)
    shape = tuple(arr.shape)
    row_bytes = max(1, int(np.prod(shape[1:]))) * dt.itemsize
    writer.reserve_array(name, shape, dt)
    chunk = max(1, max_bytes // row_bytes)
    for a in range(0, shape[0], chunk):
        writer.write_rows(name, a, _np(arr[a : a + chunk]).astype(dt, copy=False))


def _upload_chunked(arr: np.ndarray, device, sink=None, max_bytes: int = 512 << 20) -> torch.Tensor:
    """Host -> device in bounded row chunks into one preallocated tensor
    (peak: the tensor plus one chunk).  ``sink`` adds one trailing row with
    that value (the unpacked build tables' sink row)."""
    dtype = torch.from_numpy(np.zeros(0, arr.dtype)).dtype
    n = arr.shape[0]
    out = torch.empty((n + (sink is not None),) + tuple(arr.shape[1:]), dtype=dtype, device=device)
    if sink is not None:
        out[n] = sink
    row_bytes = max(1, int(np.prod(arr.shape[1:]))) * arr.dtype.itemsize
    chunk = max(1, max_bytes // row_bytes)
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        out[a:b].copy_(torch.from_numpy(np.array(arr[a:b])))
    return out


def _download_unpack_adj(adj: torch.Tensor, r_cap: int, max_bytes: int = 256 << 20) -> tuple[np.ndarray, np.ndarray]:
    """Packed ``[N/8, 8, 128]`` int32 adjacency -> host ``(neighbors, scores)``
    ``[N, r_cap]``, downloaded in bounded chunks (the caller frees ``adj``
    before uploading the halves, so the two layouts never share the card)."""
    n_pr = adj.shape[0]
    nb = np.empty((n_pr * 8, r_cap), np.int32)
    sc = np.empty((n_pr * 8, r_cap), np.float32)
    chunk = max(1, max_bytes // (8 * 128 * 4))
    for a in range(0, n_pr, chunk):
        b = min(a + chunk, n_pr)
        blk = adj[a:b].cpu().numpy().reshape(-1, 128)
        nb[a * 8 : b * 8] = blk[:, :r_cap]
        sc[a * 8 : b * 8] = np.ascontiguousarray(blk[:, 64 : 64 + r_cap]).view(np.float32)
    return nb, sc


def _ltm_wave_encode(aug, node_w2, node_norm2, sq: ScalarQuantization4, wave, start: int, cosine: bool):
    """The working set's update for one wave, in place: encode the wave and
    write its codes, per-node constants and augmented rows.  Returns the
    wave's codes."""
    wave_codes = sq.encode(wave)
    w2_w, norm2_w = sq.node_constants(wave_codes)
    stop = start + wave_codes.shape[0]
    node_w2[start:stop] = w2_w
    node_norm2[start:stop] = norm2_w
    aug[start:stop] = sq4_aug_rows(wave_codes, norm2_w if cosine else w2_w)
    return wave_codes


def _ckpt_save(path: str, writer: IndexFileWriter, seeds: _EntrySeedSampler, waves_done: int,
               arrays: dict[str, tuple], meta: dict) -> None:
    """Atomically persist mid-build state to ``path`` (a container written
    to ``path + ".tmp"`` and renamed; a torn checkpoint has no footer and
    does not load)."""
    tmp = path + ".tmp"
    w = IndexFileWriter(tmp)
    for name, (arr, dtype) in arrays.items():
        _add_array_chunked(w, name, arr, dtype)
    ss = seeds.state_dict()
    w.add_array("seeds/inserted", np.asarray(ss["inserted"], np.int32))
    w.set_meta(waves_done=waves_done, rng_state=json.dumps(ss["rng_state"]), writer_state=writer.state_dict(), **meta)
    w.close()
    os.replace(tmp, path)


def _config_knobs(config: GraphConfig) -> dict:
    """The GraphConfig knobs that shape build state, baked into every
    checkpoint and checked on resume (a resume under other knobs would splice
    two differently built halves)."""
    return {
        "wave": config.wave_size,
        "max_degree": config.max_degree,
        "ef_construction": config.ef_construction,
        "neighbor_overflow": config.neighbor_overflow,
        "alpha": config.alpha,
        "build_expand": config.build_expand,
        "build_entry_seeds": config.build_entry_seeds,
    }


def _ckpt_load(path: str, index_path: str, expect_meta: dict) -> dict | None:
    """Load a checkpoint if present, valid and built with matching knobs.

    A torn file, missing blobs, a knob mismatch, a missing or shrunken
    partial index, or an index already committed at ``index_path`` logs a
    warning and returns None: the caller rebuilds from scratch.
    """
    if not os.path.exists(path):
        return None
    try:
        if IndexFileReader(index_path).meta:
            log.warning("ignoring checkpoint %s: %s is already a committed index", path, index_path)
            return None
    except (OSError, ValueError):
        pass  # no or partial index file: the normal mid-build state
    try:
        r = IndexFileReader(path)
        for k, v in expect_meta.items():
            if r.meta.get(k) != v:
                log.warning("ignoring checkpoint %s: %s=%r != %r", path, k, r.meta.get(k), v)
                return None
        ws = r.meta["writer_state"]
        if not os.path.exists(index_path) or os.path.getsize(index_path) < ws["file_size"]:
            log.warning("ignoring checkpoint %s: partial index %s missing or shorter than checkpointed", path,
                        index_path)
            return None
        return {
            "meta": r.meta,
            "reader": r,
            "seeds_state": {"rng_state": json.loads(r.meta["rng_state"]),
                            "inserted": r.read("seeds/inserted", mmap=False)},
        }
    except (OSError, ValueError, KeyError) as e:  # torn / corrupt / foreign checkpoint
        log.warning("ignoring bad checkpoint %s: %s", path, e)
        return None


def _entry_by_centroid(provider, centroid: torch.Tensor, n: int, chunk: int = 1 << 20) -> int:
    """Node nearest the (decoded) centroid, scored in bounded chunks."""
    qstate = provider.prepare(centroid)
    best_score, best_id = -np.inf, 0
    for a in range(0, n, chunk):
        ids = torch.arange(a, min(a + chunk, n), dtype=torch.int32, device=centroid.device)
        sc = provider.score(qstate, ids[None, :])[0]
        i = int(torch.argmax(sc))
        s = float(sc[i])
        if s > best_score:
            best_score, best_id = s, a + i
    return best_id


def _gather_rows_from_loader(load, n: int, rows: np.ndarray, dim: int) -> np.ndarray:
    """``rows`` (sorted) of the corpus, read in bounded contiguous chunks."""
    out = np.empty((len(rows), dim), np.float32)
    pos = 0
    for a in range(0, n, _SAMPLE_STEP):
        sel = rows[(rows >= a) & (rows < a + _SAMPLE_STEP)]
        if len(sel):
            out[pos : pos + len(sel)] = np.asarray(load(a, min(a + _SAMPLE_STEP, n)))[sel - a]
            pos += len(sel)
    return out


def _training_sample(load, n: int, dim: int, k: int, seed: int) -> np.ndarray:
    rows = np.sort(np.random.default_rng(seed).choice(n, min(k, n), replace=False))
    return _gather_rows_from_loader(load, n, rows, dim)


def _capacity(n: int, capacity: int | None) -> int:
    """Capacity with a 1024 alignment (``capacity`` pins it near n for
    one-shot big builds)."""
    n_cap = capacity if capacity else bucket_capacity(n)
    return max(-(-n_cap // 1024) * 1024, -(-n // 1024) * 1024)


def _wave(load, start: int, n: int, w: int, dim: int, writer: IndexFileWriter, device):
    """Load one wave, write its vectors to the file's inline extent, and
    return ``(ids, ids tensor, vectors [w, dim] zero-padded)``."""
    stop = min(start + w, n)
    wave_np = np.asarray(load(start, stop), np.float32)
    writer.write_rows(f"feature/{FeatureId.INLINE_VECTORS}/vectors", start, wave_np)
    wave = torch.as_tensor(wave_np, device=device)
    if stop - start < w:  # ragged final wave: pad the queries
        wave = torch.cat([wave, torch.zeros((w - (stop - start), dim), device=device)])
    ids = np.arange(start, start + w, dtype=np.int32)
    ids = np.where(ids < n, ids, -1)
    return ids, torch.as_tensor(ids, device=device), wave


def build_on_disk_ltm(
    path: str | os.PathLike,
    vectors: np.ndarray | Callable[[int, int], np.ndarray],
    n: int,
    dim: int,
    pq: ProductQuantization | None = None,
    config: GraphConfig | None = None,
    sim: SimilarityFunction | str = SimilarityFunction.EUCLIDEAN,
    pq_m: int | None = None,
    training_sample: int = 65_536,
    seed: int = 0,
    compression: str = "pq",
    capacity: int | None = None,
    checkpoint_every: int = 0,
    device: torch.device | str | None = None,
    on_phase: Callable[[str, float], None] | None = None,
) -> tuple[GraphIndex, object]:
    """Stream-build an index bigger than device memory, writing as it goes.

    ``vectors`` is a host array or a chunk loader ``f(start, stop) ->
    np.ndarray``; the corpus is never uploaded whole.  Returns the built
    graph and the compressed provider (the working set) on ``device``
    (default: the card); the whole index (graph, inline full-resolution
    vectors, the compressed feature) is on disk at ``path``.

    ``checkpoint_every`` (waves; 0 = off) persists the build state to
    ``path + ".ckpt"``; calling again with the same arguments resumes at the
    last checkpoint.  ``on_phase(name, seconds)``, when given, is called
    after each phase (device synced): ``train``, ``waves/<regime>`` (``pq``,
    ``fused``, ``packed`` or ``plain``), ``cleanup``, ``hierarchy`` (SQ4 with
    ``add_hierarchy``) and ``save``.
    """
    sim = SimilarityFunction.parse(sim)
    config = config or GraphConfig()
    device = resolve_device(device)
    mark = _phase_timer(device, on_phase)
    load = (lambda a, b: vectors[a:b]) if isinstance(vectors, np.ndarray) else vectors
    if compression == "sq4":
        return _build_on_disk_ltm_sq4(
            str(path), load, n, dim, config, sim, training_sample, seed, capacity, checkpoint_every, device, mark
        )
    if compression != "pq":
        raise ValueError(f"compression must be 'pq' or 'sq4', got {compression!r}")

    path = str(path)
    ckpt_file = path + ".ckpt"
    expect = {"n": n, "dim": dim, "compression": "pq", "sim": str(sim.value), "seed": seed,
              "row_cap": config.row_cap, **_config_knobs(config)}
    ckpt = _ckpt_load(ckpt_file, path, expect) if checkpoint_every else None

    def fit_pq() -> ProductQuantization:
        sample = _training_sample(load, n, dim, training_sample, seed)
        return ProductQuantization.compute(sample, m=pq_m or max(4, dim // 8), clusters=256, seed=seed, device=device)

    pq_arg = pq
    if ckpt is not None:
        r = ckpt["reader"]
        pq = ProductQuantization(
            codebooks=torch.as_tensor(r.read("pq/codebooks", mmap=False).copy(), device=device),
            center=torch.as_tensor(r.read("pq/center", mmap=False).copy(), device=device)
            if r.has_array("pq/center") else None,
            original_dim=int(ckpt["meta"]["pq_original_dim"]),
        )
    elif pq is None:
        pq = fit_pq()

    n_cap = _capacity(n, capacity)
    if ckpt is not None and int(ckpt["meta"]["n_cap"]) != n_cap:
        log.warning("checkpoint %s: layout mismatch, rebuilding", ckpt_file)
        ckpt, pq = None, pq_arg if pq_arg is not None else fit_pq()

    w = config.wave_size
    n_waves = (n + w - 1) // w
    seeds = _EntrySeedSampler(n, w, config.build_entry_seeds)
    waves_done = 0
    if ckpt is not None:
        # reopen the partial file before the device restore: a missing or
        # shrunken file downgrades to a clean rebuild
        try:
            writer = IndexFileWriter.resume(path, ckpt["meta"]["writer_state"])
        except (ValueError, OSError) as e:
            log.warning("cannot resume %s (%s); rebuilding", path, e)
            ckpt, pq = None, pq_arg if pq_arg is not None else fit_pq()
    if ckpt is not None:
        r = ckpt["reader"]
        codes = _upload_chunked(r.read("state/codes"), device)
        graph = GraphIndex(
            layers=(GraphLayer(
                neighbors=_upload_chunked(_read_l0_neighbors(r, mmap=True), device, sink=-1),
                scores=_upload_chunked(r.read("graph/L0/scores"), device, sink=NEG_INF),
                counts=_upload_chunked(r.read("graph/L0/counts"), device, sink=0),
            ),),
            level_node_ids=(),
            entry_node=torch.tensor(int(ckpt["meta"]["entry_node"]), dtype=torch.int32, device=device),
            num_nodes=torch.tensor(int(ckpt["meta"]["num_nodes"]), dtype=torch.int32, device=device),
            deleted=torch.zeros((n_cap,), dtype=torch.bool, device=device),
        )
        seeds.load_state_dict(ckpt["seeds_state"])
        waves_done = int(ckpt["meta"]["waves_done"])
        log.info("resuming ltm build at wave %d/%d", waves_done, n_waves)
    else:
        codes = torch.zeros((n_cap, pq.m), dtype=torch.uint8, device=device)
        graph = _sink_graph(n_cap, config, device)
        writer = IndexFileWriter(path)
        writer.reserve_array(f"feature/{FeatureId.INLINE_VECTORS}/vectors", (n, dim), np.float32)
    provider = ADCScoreProvider(codes=codes, codebooks=pq.codebooks, center=pq.center, sim=sim)
    mark("train")

    def checkpoint(wi_done: int) -> None:
        base = _drop_sink(graph).base
        arrs = {
            "graph/L0/neighbors": (base.neighbors, np.int32),
            "graph/L0/scores": (base.scores, np.float32),
            "graph/L0/counts": (base.counts, np.int32),
            "state/codes": (codes, np.uint8),
            "pq/codebooks": (pq.codebooks, np.float32),
        }
        if pq.center is not None:
            arrs["pq/center"] = (pq.center, np.float32)
        _ckpt_save(ckpt_file, writer, seeds, wi_done, arrs, dict(
            expect, n_cap=n_cap, entry_node=int(graph.entry_node), num_nodes=int(graph.num_nodes),
            pq_original_dim=pq.original_dim,
        ))
        log.info("ltm checkpoint at wave %d/%d", wi_done, n_waves)

    # stream waves in the shuffled order: the loader sees contiguous chunk
    # reads and the inline vector writes are positional
    for wi, start in enumerate(_shuffled_wave_starts(n, w)):
        if wi < waves_done:
            continue  # resumed: the state already holds these waves
        ids, ids_dev, wave = _wave(load, start, n, w, dim, writer, device)
        stop = min(start + w, n)
        codes[start:stop] = pq.encode(wave[: stop - start])
        graph = _insert_wave(graph, provider, ids_dev, wave, config, seed_ids=seeds.sample(device))
        seeds.record(ids)
        if checkpoint_every and (wi + 1) % checkpoint_every == 0 and (wi + 1) < n_waves:
            checkpoint(wi + 1)
    mark("waves/pq")

    graph = GraphIndexBuilder(config).cleanup(_drop_sink(graph), provider, vectors=None)
    # entry point: the node nearest the mean of the decoded codes
    centroid = torch.mean(pq.decode(codes[: min(n, 65_536)]), dim=0, keepdim=True)
    graph = graph._replace(
        entry_node=torch.tensor(_entry_by_centroid(provider, centroid, n), dtype=torch.int32, device=device)
    )
    mark("cleanup")

    for lv, layer in enumerate(graph.layers):
        writer.add_array(f"graph/L{lv}/neighbors", layer.neighbors)
        writer.add_array(f"graph/L{lv}/counts", layer.counts)
    writer.add_array(f"feature/{FeatureId.PQ_CODES}/codes", codes)
    writer.add_array(f"feature/{FeatureId.PQ_CODES}/codebooks", pq.codebooks)
    if pq.center is not None:
        writer.add_array(f"feature/{FeatureId.PQ_CODES}/center", pq.center)
    writer.set_meta(
        num_levels=graph.num_levels,
        entry_node=int(graph.entry_node),
        num_nodes=int(graph.num_nodes),
        features=[FeatureId.INLINE_VECTORS, FeatureId.PQ_CODES],
        similarity=str(sim.value),
        dimension=dim,
        pq_original_dim=pq.original_dim,
        ltm=True,
    )
    writer.close()
    # a stale .ckpt from an earlier crashed run must never outlive a
    # committed index
    if os.path.exists(ckpt_file):
        os.remove(ckpt_file)
    mark("save")
    return graph, provider


def _node_const(node_w2: torch.Tensor, node_norm2: torch.Tensor, cosine: bool) -> torch.Tensor:
    """The per-node SQ4 constant the similarity uses."""
    return node_norm2 if cosine else node_w2


def _sq4_regime(config: GraphConfig, n_cap: int, mp: int) -> str:
    """``"fused"``, ``"packed"`` or ``"plain"`` for a fused-aligned config."""
    fused_bytes = n_cap * config.row_cap * (mp + 4)
    if (config.row_cap * mp) % 1024 == 0 and (mp % 128 == 0 or 128 % mp == 0) and fused_bytes < _FUSED_BUILD_BUDGET:
        return "fused"
    return "packed" if _packed_adj_eligible(config, n_cap) else "plain"


def _build_on_disk_ltm_sq4(path, load, n, dim, config, sim, training_sample, seed, capacity, checkpoint_every,
                           device, mark):
    """SQ4 LTM build: 4-bit working set + fused-SQ4 save for host serving."""
    ckpt_file = path + ".ckpt"
    expect = {"n": n, "dim": dim, "compression": "sq4", "sim": str(sim.value), "seed": seed,
              **_config_knobs(config)}
    ckpt = _ckpt_load(ckpt_file, path, expect) if checkpoint_every else None

    def fit_sq() -> ScalarQuantization4:
        return ScalarQuantization4.compute(_training_sample(load, n, dim, training_sample, seed), device=device)

    if ckpt is not None:
        r = ckpt["reader"]
        sq = ScalarQuantization4(
            scale=torch.as_tensor(r.read("sq/scale", mmap=False).copy(), device=device),
            offset=torch.as_tensor(r.read("sq/offset", mmap=False).copy(), device=device),
            original_dim=int(ckpt["meta"]["sq_original_dim"]),
        )
    else:
        sq = fit_sq()

    n_cap = _capacity(n, capacity)
    mp = sq.padded_dim // 2
    config = _fused_aligned_config(config, mp)
    regime = _sq4_regime(config, n_cap, mp)
    fused_build, packed_build = regime == "fused", regime == "packed"
    cosine = sim == SimilarityFunction.COSINE

    def make_provider(codes, node_w2, node_norm2, aug) -> SQ4ScoreProvider:
        # empty fused tables: the search scores plain (augmented) code rows;
        # the fused layout is written once the adjacency is final
        return SQ4ScoreProvider(
            codes_packed=codes, node_w2=node_w2, node_norm2=node_norm2,
            fused_packed=torch.zeros((n_cap, 0), dtype=torch.uint8, device=device),
            fused_w2=torch.zeros((n_cap, 0), device=device),
            scale=sq.scale, offset=sq.offset, codes_aug=aug, sim=sim,
        )

    w = config.wave_size
    n_waves = (n + w - 1) // w
    seeds = _EntrySeedSampler(n, w, config.build_entry_seeds)
    waves_done = 0
    if ckpt is not None and (
        int(ckpt["meta"]["n_cap"]) != n_cap
        or int(ckpt["meta"]["row_cap"]) != config.row_cap
        or bool(ckpt["meta"]["fused"]) != fused_build
        or bool(ckpt["meta"].get("packed", False)) != packed_build
    ):
        log.warning("checkpoint %s: layout mismatch, rebuilding", ckpt_file)
        ckpt, sq = None, fit_sq()
    if ckpt is not None:
        try:
            writer = IndexFileWriter.resume(path, ckpt["meta"]["writer_state"])
        except (ValueError, OSError) as e:
            log.warning("cannot resume %s (%s); rebuilding", path, e)
            ckpt, sq = None, fit_sq()

    # non-fused regimes keep one device copy of the codes (inside the
    # augmented rows); the fused regime needs the codes tensor for its
    # table updates
    adj = counts = entry = num_nodes = graph = codes = fused_packed = fused_w2 = None
    if ckpt is not None:
        # the state comes straight from the checkpoint, nothing preallocated
        r = ckpt["reader"]
        entry = torch.tensor(int(ckpt["meta"]["entry_node"]), dtype=torch.int32, device=device)
        num_nodes = torch.tensor(int(ckpt["meta"]["num_nodes"]), dtype=torch.int32, device=device)
        if packed_build:
            adj = _upload_chunked(r.read("state/adj_packed"), device)
            counts = _upload_chunked(r.read("graph/L0/counts"), device)
        else:
            graph = GraphIndex(
                layers=(GraphLayer(
                    neighbors=_upload_chunked(_read_l0_neighbors(r, mmap=True), device, sink=-1),
                    scores=_upload_chunked(r.read("graph/L0/scores"), device, sink=NEG_INF),
                    counts=_upload_chunked(r.read("graph/L0/counts"), device, sink=0),
                ),),
                level_node_ids=(), entry_node=entry, num_nodes=num_nodes,
                deleted=torch.zeros((n_cap,), dtype=torch.bool, device=device),
            )
        aug = _upload_chunked(r.read("state/aug"), device)
        node_w2 = _upload_chunked(r.read("state/node_w2"), device)
        node_norm2 = _upload_chunked(r.read("state/node_norm2"), device)
        if fused_build:
            codes = _upload_chunked(r.read("state/codes"), device)
            fused_packed = _upload_chunked(r.read("state/fused_packed"), device, sink=0)
            fused_w2 = _upload_chunked(r.read("state/fused_w2"), device, sink=0.0)
        seeds.load_state_dict(ckpt["seeds_state"])
        waves_done = int(ckpt["meta"]["waves_done"])
        log.info("resuming ltm build at wave %d/%d", waves_done, n_waves)
    else:
        node_w2 = torch.zeros((n_cap,), device=device)
        node_norm2 = torch.zeros((n_cap,), device=device)
        aug = torch.zeros((n_cap, mp + 4), dtype=torch.uint8, device=device)
        if fused_build:
            # one extra sink row, as in the in-memory fused loop
            fused_packed = torch.zeros((n_cap + 1, config.row_cap * mp // 128, 128), dtype=torch.uint8, device=device)
            fused_w2 = torch.zeros((n_cap + 1, config.row_cap), device=device)
            codes = torch.zeros((n_cap, mp), dtype=torch.uint8, device=device)
        if packed_build:
            # the packed table is the graph until the unpack
            adj = _empty_packed_adjacency(n_cap, config.row_cap, device)
            counts = torch.zeros((n_cap,), dtype=torch.int32, device=device)
            entry = torch.tensor(-1, dtype=torch.int32, device=device)
            num_nodes = torch.tensor(0, dtype=torch.int32, device=device)
        else:
            graph = _sink_graph(n_cap, config, device)
        writer = IndexFileWriter(path)
        writer.reserve_array(f"feature/{FeatureId.INLINE_VECTORS}/vectors", (n, dim), np.float32)
    mark("train")

    def checkpoint(wi_done: int) -> None:
        if packed_build:
            arrs = {"state/adj_packed": (adj, np.int32), "graph/L0/counts": (counts, np.int32)}
            ckpt_entry, ckpt_num = int(entry), int(num_nodes)
        else:
            base = _drop_sink(graph).base
            arrs = {
                "graph/L0/neighbors": (base.neighbors, np.int32),
                "graph/L0/scores": (base.scores, np.float32),
                "graph/L0/counts": (base.counts, np.int32),
            }
            ckpt_entry, ckpt_num = int(graph.entry_node), int(graph.num_nodes)
        arrs.update({
            "state/aug": (aug, np.uint8),
            "state/node_w2": (node_w2, np.float32),
            "state/node_norm2": (node_norm2, np.float32),
            "sq/scale": (sq.scale, np.float32),
            "sq/offset": (sq.offset, np.float32),
        })
        if fused_build:
            arrs["state/codes"] = (codes, np.uint8)
            arrs["state/fused_packed"] = (fused_packed[:n_cap], np.uint8)
            arrs["state/fused_w2"] = (fused_w2[:n_cap], np.float32)
        _ckpt_save(ckpt_file, writer, seeds, wi_done, arrs, dict(
            expect, n_cap=n_cap, row_cap=config.row_cap, fused=fused_build, packed=packed_build,
            entry_node=ckpt_entry, num_nodes=ckpt_num, sq_original_dim=sq.original_dim,
        ))
        log.info("ltm checkpoint at wave %d/%d", wi_done, n_waves)

    t_wave = time.time()
    for wi, start in enumerate(_shuffled_wave_starts(n, w)):
        if wi < waves_done:
            continue  # resumed: the state already holds these waves
        if wi and wi % 256 == 0:
            log.info("ltm build wave %d/%d (%.1fs)", wi, n_waves, time.time() - t_wave)
        ids, ids_dev, wave = _wave(load, start, n, w, dim, writer, device)
        stop = min(start + w, n)
        wave_codes = _ltm_wave_encode(aug, node_w2, node_norm2, sq, wave[: stop - start], start, cosine)
        if fused_build:
            codes[start:stop] = wave_codes
        provider = make_provider(codes, node_w2, node_norm2, aug)
        seed_dev = seeds.sample(device)
        if fused_build:
            # fused wave search + slot-exact table upkeep; the rescore and
            # the prune run on the same SQ4 provider (full-resolution rows of
            # arbitrary nodes are not on the device)
            bp = dataclasses.replace(provider, fused_packed=fused_packed, fused_w2=fused_w2)
            beam_ids, beam_scores = _wave_search(graph.base.neighbors, bp, graph.entry_node, ids_dev, wave, config,
                                                 seed_dev)
            graph = _wave_update_fused(graph, fused_packed, fused_w2, provider, codes,
                                       _node_const(node_w2, node_norm2, cosine), ids_dev, wave, beam_ids,
                                       beam_scores, config)
        elif packed_build:
            # the packed three-step wave: read-only search on the packed
            # table, update streams computed against the pre-state (pruned on
            # the search's own SQ4 scores), K3 applies them in place
            beam_ids, beam_scores = _wave_search(adj, provider, entry, ids_dev, wave, config, seed_dev)
            counts, entry, num_nodes, adj_stream, _ = _wave_update_compute(
                adj, counts, entry, num_nodes, provider, None, None, ids_dev, wave, beam_ids, beam_scores, config,
                rescore=False, with_fused=False,
            )
            _wave_apply_adj_only(adj, adj_stream)
        else:
            graph = _insert_wave(graph, provider, ids_dev, wave, config, seed_ids=seed_dev)
        seeds.record(ids)
        if checkpoint_every and (wi + 1) % checkpoint_every == 0 and (wi + 1) < n_waves:
            checkpoint(wi + 1)
    mark(f"waves/{regime}")

    provider = make_provider(codes, node_w2, node_norm2, aug)
    nb_host = None
    if packed_build:
        # enforce the degree on the packed layout, then unpack through the
        # host so the packed table and the [N, R] halves never share the card
        packed_cleanup(adj, counts, provider, config, num_nodes)
        nb_host, sc_host = _download_unpack_adj(adj, config.row_cap)
        del adj
        graph = GraphIndex(
            layers=(GraphLayer(neighbors=_upload_chunked(nb_host, device), scores=_upload_chunked(sc_host, device),
                               counts=counts),),
            level_node_ids=(), entry_node=entry, num_nodes=num_nodes,
            deleted=torch.zeros((n_cap,), dtype=torch.bool, device=device),
        )
        del sc_host
    else:
        graph = _drop_sink(graph)
        fused_packed = fused_w2 = None  # the save rebuilds the layout from the final adjacency
    # packed builds enforced the degree on the packed layout already
    graph = GraphIndexBuilder(config).cleanup(graph, provider, vectors=None, enforce=not packed_build)
    centroid = torch.mean(provider.decode(torch.arange(min(n, 65_536), device=device)), dim=0)[None]
    graph = graph._replace(
        entry_node=torch.tensor(_entry_by_centroid(provider, centroid, n), dtype=torch.int32, device=device)
    )
    mark("cleanup")

    if config.add_hierarchy:
        # upper levels over the ~n/max_degree sampled nodes; their vectors
        # come from the source in one chunked pass
        levels = assign_levels(n, config.max_degree, seed)
        sub_ids = np.where(levels >= 1)[0].astype(np.int32)
        if len(sub_ids):
            sub_vecs = _gather_rows_from_loader(load, n, sub_ids, dim)
            graph = GraphIndexBuilder(config).build_hierarchy_from_subset(
                graph, sub_ids, torch.as_tensor(sub_vecs, device=device), levels[sub_ids], sim
            )
            log.info("ltm hierarchy: %d levels over %d nodes", graph.num_levels - 1, len(sub_ids))
        mark("hierarchy")

    # the final fused layout against the cleaned adjacency: small indexes
    # keep the fused tables on the device; big ones stream the layout into
    # the file from the host and return a fused-less provider
    const = _node_const(node_w2, node_norm2, cosine)
    r_cap = graph.row_cap
    keep_fused_on_device = n_cap * r_cap * (mp + 4) < _FUSED_SERVE_BUDGET
    if not keep_fused_on_device and nb_host is None:
        nb_host = np.empty((n_cap, r_cap), np.int32)
        step = max(1, (256 << 20) // (r_cap * 4))
        for a in range(0, n_cap, step):
            nb_host[a : a + step] = graph.base.neighbors[a : a + step].cpu().numpy()
    for lv, layer in enumerate(graph.layers):
        if lv == 0 and nb_host is not None:
            writer.add_array("graph/L0/neighbors", nb_host)
        else:
            _add_array_chunked(writer, f"graph/L{lv}/neighbors", layer.neighbors, np.int32)
        writer.add_array(f"graph/L{lv}/counts", layer.counts)
        if lv >= 1:
            writer.add_array(f"graph/L{lv}/node_ids", graph.level_node_ids[lv - 1])
    f = f"feature/{FeatureId.FUSED_SQ4}"
    if codes is None:
        codes = provider._codes_array()  # the loop is over: the transient fits now
    if keep_fused_on_device:
        _add_array_chunked(writer, f"{f}/codes_packed", codes, np.uint8)
    else:
        codes_np = np.empty((n_cap, mp), np.uint8)
        step = max(1, (256 << 20) // mp)
        for a in range(0, n_cap, step):
            codes_np[a : a + step] = codes[a : a + step].cpu().numpy()
        writer.add_array(f"{f}/codes_packed", codes_np)
    writer.add_array(f"{f}/node_const", const)
    if keep_fused_on_device:
        fused_packed, fused_w2 = build_fused_sq4(graph.base.neighbors, codes, const)
        provider = dataclasses.replace(provider, codes_packed=codes, fused_packed=fused_packed, fused_w2=fused_w2)
        _add_array_chunked(writer, f"{f}/fused_packed", fused_packed, np.uint8)
        _add_array_chunked(writer, f"{f}/fused_w2", fused_w2, np.float32)
    else:
        provider = make_provider(codes, node_w2, node_norm2, aug)
        writer.reserve_array(f"{f}/fused_packed", (n_cap, r_cap * mp), np.uint8)
        writer.reserve_array(f"{f}/fused_w2", (n_cap, r_cap), np.float32)
        # the host-side fused layout: a pure gather of host-resident codes
        const_np = const.cpu().numpy()
        chunk = max(1, (1 << 29) // (r_cap * mp))
        for a in range(0, n_cap, chunk):
            fp_c, fw_c = build_fused_sq4_host(nb_host[a : a + chunk], codes_np, const_np)
            writer.write_rows(f"{f}/fused_packed", a, fp_c)
            writer.write_rows(f"{f}/fused_w2", a, fw_c)
    writer.add_array(f"{f}/scale", sq.scale)
    writer.add_array(f"{f}/offset", sq.offset)
    writer.set_meta(
        num_levels=graph.num_levels,
        entry_node=int(graph.entry_node),
        num_nodes=int(graph.num_nodes),
        features=[FeatureId.INLINE_VECTORS, FeatureId.FUSED_SQ4],
        similarity=str(sim.value),
        dimension=dim,
        ltm=True,
    )
    writer.close()
    if os.path.exists(ckpt_file):
        os.remove(ckpt_file)
    mark("save")
    return graph, provider
