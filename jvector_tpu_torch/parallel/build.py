"""Sharded index construction, sharded serving and sharded persistence
(counterpart of ``jvector_tpu/parallel/build.py``).

- **Build**: the corpus is block-partitioned over the mesh (shard ``s``
  owns global ids ``[s * n_local, (s + 1) * n_local)``) and each shard's
  graph is built on its device by the port's own wave functions: the exact
  wave insert, the unpacked SQ4 loop with fused tables, or the packed loop
  whose apply launches K1 and K2 once per shard per wave.  No shard reads
  another's tables.  The shards share one wave order and one quantizer,
  fitted on the whole corpus, so first-pass scores compare across shards.
- **Serve**: every shard beam-searches its graph from its own entry,
  reranks its candidates exactly, and the merge keeps the global top-k
  (see :mod:`jvector_tpu_torch.parallel.sharding` for the mesh and the
  merge).
- **Persist**: :func:`save_sharded` writes one container per shard plus
  ``manifest.json``, byte-compatible with the JAX package's;
  :func:`load_sharded` reopens such a directory onto a mesh, written by
  either package, any L0 layout included.
- :func:`sharded_build_on_disk` stream-builds one larger-than-memory shard
  file per partition (``disk/ltm.py``), each with its own quantizer.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from jvector_tpu_torch.disk.format import FeatureId, IndexFileReader, _read_l0_neighbors, load_index, write_index
from jvector_tpu_torch.disk.ltm import _node_const, build_on_disk_ltm
from jvector_tpu_torch.graph.builder import (
    _drop_sink,
    _empty_packed_adjacency,
    _fused_aligned_config,
    _insert_wave,
    _packed_build_eligible,
    _shuffled_wave_starts,
    _sink_graph,
    _unpack_adjacency,
    _wave_apply_packed,
    _wave_search,
    _wave_update_compute,
    _wave_update_fused,
)
from jvector_tpu_torch.graph.index import NEG_INF, GraphConfig, GraphIndex, GraphLayer, bucket_capacity
from jvector_tpu_torch.graph.score import ExactScoreProvider, SQ4ScoreProvider, sq4_aug_rows
from jvector_tpu_torch.graph.searcher import _top_k_stable, search_layer
from jvector_tpu_torch.ops.similarity import SimilarityFunction
from jvector_tpu_torch.parallel.sharding import Mesh, _gather, replicate
from jvector_tpu_torch.quantization.sq import ScalarQuantization4


@dataclasses.dataclass
class ShardedIndex:
    """Per-shard graphs and providers, shard ``s`` on ``mesh.devices[s]``."""

    graphs: list[GraphIndex]
    providers: list[ExactScoreProvider]  # exact rerank, vectors [n_local, D]
    n_shards: int
    n_local: int  # capacity per shard
    n_total: int  # true corpus size
    # fused-SQ4 first-pass providers; None for exact-only builds
    search_providers: list[SQ4ScoreProvider] | None = None
    sim: SimilarityFunction = SimilarityFunction.EUCLIDEAN

    def global_ids(self, shard: int, local_ids: np.ndarray) -> np.ndarray:
        return shard * self.n_local + local_ids


def _wave_inputs(start: int, w: int, count: int, vectors: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One shard's wave: ids ``[start, start + w)``, -1 past the shard's
    count, and their vectors (clamped into the capacity)."""
    ids = np.arange(start, start + w, dtype=np.int32)
    dev = vectors.device
    rows = torch.as_tensor(np.clip(ids, 0, vectors.shape[0] - 1), device=dev)
    return torch.as_tensor(np.where(ids < count, ids, -1), device=dev), vectors[rows.long()]


def sharded_build(
    vectors: np.ndarray | torch.Tensor,
    mesh: Mesh,
    config: GraphConfig | None = None,
    sim: SimilarityFunction | str = SimilarityFunction.EUCLIDEAN,
    axis: str = "shard",
    build_compression: str | None = "sq4",
) -> ShardedIndex:
    """Build one subgraph per mesh device over a block node partition.

    ``build_compression="sq4"`` (default) runs the compressed build per
    shard: SQ4 wave searches, exact rescore + prune, incremental fused
    tables; the returned index's ``search_providers`` serve the fused first
    pass.  ``None`` builds and serves full precision.
    """
    sim = SimilarityFunction.parse(sim)
    config = config or GraphConfig()
    vectors = vectors.cpu().numpy() if isinstance(vectors, torch.Tensor) else np.asarray(vectors, np.float32)
    n, d = vectors.shape
    if build_compression == "sq4":
        # whole-tile fused rows -> in-place table updates per shard
        config = _fused_aligned_config(config, (d + 1) // 2)
    n_dev = mesh.size
    # shard capacity rounded to %8: the packed [N/8, 8, 128] adjacency
    # needs it, and a few inert pad rows cost nothing in the other modes
    n_local = ((-(-n // n_dev) + 7) // 8) * 8
    vp = np.zeros((n_dev * n_local, d), np.float32)
    vp[:n] = vectors
    providers = [
        ExactScoreProvider(vectors=torch.as_tensor(vp[s * n_local : (s + 1) * n_local], device=dev), sim=sim)
        for s, dev in enumerate(mesh.devices)
    ]
    # per-shard live count (rounding can leave several ragged tail shards)
    counts = np.clip(n - np.arange(n_dev) * n_local, 0, n_local)
    if build_compression == "sq4":
        return _sharded_build_sq4(vectors, providers, counts, mesh, config, sim, n_local)

    graphs = [_sink_graph(n_local, config, dev) for dev in mesh.devices]
    for start in _shuffled_wave_starts(n_local, config.wave_size):
        for s, p in enumerate(providers):
            ids, wv = _wave_inputs(start, config.wave_size, counts[s], p.vectors)
            graphs[s] = _insert_wave(graphs[s], p, ids, wv, config)
    return ShardedIndex(
        graphs=[_drop_sink(g) for g in graphs], providers=providers, n_shards=n_dev, n_local=n_local,
        n_total=n, sim=sim,
    )


def _sharded_build_sq4(vectors, providers, counts, mesh, config, sim, n_local) -> ShardedIndex:
    """The compressed sharded build: a global SQ4 fit on the unpadded
    corpus, each shard's padded rows encoded on its device, then the packed
    or the unpacked wave loop per shard."""
    sq = ScalarQuantization4.compute(vectors, device="cpu")  # global fit, random sample
    bases = []
    for p in providers:
        dev = p.vectors.device
        sq_s = dataclasses.replace(sq, scale=sq.scale.to(dev), offset=sq.offset.to(dev))
        codes = sq_s.encode(p.vectors)
        w2, norm2 = sq_s.node_constants(codes)
        const = norm2 if sim == SimilarityFunction.COSINE else w2
        empty = torch.zeros((n_local, 0), device=dev)
        bases.append(SQ4ScoreProvider(
            codes_packed=codes, node_w2=w2, node_norm2=norm2, fused_packed=empty.to(torch.uint8),
            fused_w2=empty, scale=sq_s.scale, offset=sq_s.offset, codes_aug=sq4_aug_rows(codes, const), sim=sim,
        ))
    mp = bases[0].codes_packed.shape[1]
    loop = _packed_loop if _packed_build_eligible(config, mp, n_local) else _fused_loop
    graphs, search_providers = loop(bases, providers, counts, config, sim, n_local)
    return ShardedIndex(
        graphs=graphs, providers=providers, n_shards=mesh.size, n_local=n_local, n_total=int(counts.sum()),
        search_providers=search_providers, sim=sim,
    )


def _fused_loop(bases, providers, counts, config, sim, n_local):
    """The unpacked loop per shard: an ``[n_local + 1, R]`` graph (sink row)
    beside 2-D fused tables, updated in place; no entry seeds."""
    w, r_cap, mp = config.wave_size, config.row_cap, bases[0].codes_packed.shape[1]
    graphs, bps = [], []
    for bp in bases:
        dev = bp.codes_packed.device
        graphs.append(_sink_graph(n_local, config, dev))
        bps.append(dataclasses.replace(
            bp,
            fused_packed=torch.zeros((n_local + 1, r_cap * mp), dtype=torch.uint8, device=dev),
            fused_w2=torch.zeros((n_local + 1, r_cap), device=dev),
        ))
    for start in _shuffled_wave_starts(n_local, w):
        for s, (bp, p) in enumerate(zip(bps, providers)):
            ids, wv = _wave_inputs(start, w, counts[s], p.vectors)
            g = graphs[s]
            bi, bs = _wave_search(g.base.neighbors, bp, g.entry_node, ids, wv, config)
            const = _node_const(bp.node_w2, bp.node_norm2, sim == SimilarityFunction.COSINE)
            graphs[s] = _wave_update_fused(
                g, bp.fused_packed, bp.fused_w2, p, bp.codes_packed, const, ids, wv, bi, bs, config,
            )
    return (
        [_drop_sink(g) for g in graphs],
        [dataclasses.replace(bp, fused_packed=bp.fused_packed[:n_local], fused_w2=bp.fused_w2[:n_local])
         for bp in bps],
    )


def _packed_loop(bases, providers, counts, config, sim, n_local):
    """The packed-adjacency loop per shard: search on the packed tables,
    read + compute the write streams, apply them in place with K1 (packed
    adjacency + w2) and K2 (fused codes).  As the JAX package's sharded
    loop: no entry seeds, no packed cleanup, no hierarchy."""
    w, r_cap, mp = config.wave_size, config.row_cap, bases[0].codes_packed.shape[1]
    st = []
    for bp in bases:
        dev = bp.codes_packed.device
        fused = torch.zeros((n_local, r_cap * mp // 128, 128), dtype=torch.uint8, device=dev)
        w2t = torch.zeros((n_local // 8, 8, 128), dtype=torch.int32, device=dev)
        st.append(dict(
            bp=dataclasses.replace(bp, fused_packed=fused, fused_w2=w2t),
            adj=_empty_packed_adjacency(n_local, r_cap, dev),
            cnt=torch.zeros((n_local,), dtype=torch.int32, device=dev),
            entry=torch.tensor(-1, dtype=torch.int32, device=dev),
            num=torch.tensor(0, dtype=torch.int32, device=dev),
        ))
    for start in _shuffled_wave_starts(n_local, w):
        for s, (t, p) in enumerate(zip(st, providers)):
            ids, wv = _wave_inputs(start, w, counts[s], p.vectors)
            bp = t["bp"]
            bi, bs = _wave_search(t["adj"], bp, t["entry"], ids, wv, config)
            const = _node_const(bp.node_w2, bp.node_norm2, sim == SimilarityFunction.COSINE)
            t["cnt"], t["entry"], t["num"], adj_stream, fused_stream = _wave_update_compute(
                t["adj"], t["cnt"], t["entry"], t["num"], p, bp.codes_packed, const, ids, wv, bi, bs, config,
            )
            _wave_apply_packed(t["adj"], bp.fused_w2, bp.fused_packed, adj_stream, fused_stream)
    graphs = [
        GraphIndex(
            layers=(_unpack_adjacency(t["adj"], t["cnt"], r_cap),), level_node_ids=(), entry_node=t["entry"],
            num_nodes=t["num"], deleted=torch.zeros((n_local,), dtype=torch.bool, device=t["cnt"].device),
        )
        for t in st
    ]
    return graphs, [t["bp"] for t in st]


def sharded_graph_search(
    index: ShardedIndex,
    queries: torch.Tensor | np.ndarray,
    mesh: Mesh,
    top_k: int,
    beam_width: int | None = None,
    rerank_k: int | None = None,
    axis: str = "shard",
    floor_slack: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Replicated queries, shard-local beam search, merged top-k.

    With a compressed index (``search_providers`` set) this is a two-pass
    search: the fused SQ4 first pass per shard, a shard-local exact rerank
    of the top ``rerank_k`` beam entries, then the merge of exact scores.

    The reference's rerankFloor gating (``GraphSearcher.java:386-404``) is
    off by default, as in the JAX package: gating on the cross-shard
    approximate floor drops exact top-k candidates whose approximate score
    sits below it.  ``floor_slack`` turns it on: only candidates whose
    approximate score reaches the global top-k-th approximate score less
    the slack are reranked.

    Returns global ids ``[Q, top_k]`` and their scores, on
    ``mesh.devices[0]``.
    """
    beam_width = beam_width or max(top_k, 100)
    rerank_k = rerank_k or beam_width
    n_local, n_total = index.n_local, index.n_total
    two_pass = index.search_providers is not None
    firsts = index.search_providers if two_pass else index.providers
    qs = replicate(torch.as_tensor(queries, dtype=torch.float32), mesh)
    qn = qs[0].shape[0]
    beams = []
    for graph, first, q in zip(index.graphs, firsts, qs):
        entries = graph.entry_node.expand(qn).to(torch.int32)
        beams.append(search_layer(graph.base.neighbors, first, first.prepare(q), entries,
                                  beam_width=beam_width, max_iters=1000))
    if two_pass:
        cands = []
        for s, beam in enumerate(beams):
            cand_ids = beam.ids[:, :rerank_k]
            valid = (cand_ids >= 0) & (cand_ids + s * n_local < n_total)
            cands.append((cand_ids, valid, torch.where(valid, beam.scores[:, :rerank_k], NEG_INF)))
        floor = None
        if floor_slack is not None:
            # the cross-shard approximate floor: the global top-k-th approximate score
            approx_all = _gather([c[2][:, :top_k] for c in cands], mesh.devices[0], 1)
            floor = _top_k_stable(approx_all, top_k)[0][:, -1] - floor_slack
    scores, gids = [], []
    for s, (beam, ep, q) in enumerate(zip(beams, index.providers, qs)):
        if two_pass:
            cand_ids, valid, cand_approx = cands[s]
            rr = valid if floor is None else valid & (cand_approx >= floor.to(q.device)[:, None])
            exact = torch.where(rr, ep.score(ep.prepare(q), torch.clamp(cand_ids, min=0)), NEG_INF)
            sc, sel = _top_k_stable(exact, top_k)
            local = torch.gather(cand_ids, 1, sel)
        else:
            sc, sel = _top_k_stable(beam.scores, top_k)
            local = torch.gather(beam.ids, 1, sel)
        g = torch.where(local >= 0, local + s * n_local, -1)
        ok = (g >= 0) & (g < n_total) & (sc > NEG_INF)
        scores.append(torch.where(ok, sc, NEG_INF))
        gids.append(torch.where(ok, g, -1))
    dev0 = mesh.devices[0]
    top, pick = _top_k_stable(_gather(scores, dev0, 1), top_k)
    return torch.gather(_gather(gids, dev0, 1), 1, pick), top


# ---------------------------------------------------------------------------
# Sharded persistence: one container per shard + a manifest.
# ---------------------------------------------------------------------------


def save_sharded(index: ShardedIndex, directory: str | os.PathLike) -> None:
    """Write each shard as an ordinary index container + ``manifest.json``.

    Shard files use the FUSED_SQ4 feature layout of the host tier
    (``disk/ltm.py``), so a single shard is also servable by
    ``HostGraphIndex.load`` or :func:`jvector_tpu_torch.disk.format.load_index`.
    """
    directory = os.fspath(directory)
    os.makedirs(directory, exist_ok=True)
    files = []
    for s in range(index.n_shards):
        graph = index.graphs[s]
        feats = {FeatureId.INLINE_VECTORS: {"vectors": index.providers[s].vectors}}
        if index.search_providers is not None:
            sp = index.search_providers[s]
            # the packed build's layouts in the on-disk 2-D convention: rank-3
            # fused rows flatten, and the packed [n/8, 8, 128] int32 w2 table
            # (float32 bits in lanes [0:R]) unpacks to [n, R] float32
            fp = sp.fused_packed
            if fp.dim() == 3:
                fp = fp.reshape(fp.shape[0], -1)
            fw = sp.fused_w2
            if fw.dim() == 3:
                fw = fw.reshape(-1, 128)[:, : graph.base.neighbors.shape[-1]].contiguous().view(torch.float32)
            feats[FeatureId.FUSED_SQ4] = {
                "codes_packed": sp.codes_packed,
                "node_const": _node_const(sp.node_w2, sp.node_norm2, index.sim == SimilarityFunction.COSINE),
                "fused_packed": fp,
                "fused_w2": fw,
                "scale": sp.scale,
                "offset": sp.offset,
            }
        fname = f"shard{s:04d}.jvtpu"
        write_index(os.path.join(directory, fname), graph, features=feats, renumber=False,
                    similarity=str(index.sim.value), shard=s)
        files.append(fname)
    _write_manifest(directory, {
        "version": 1, "n_shards": index.n_shards, "n_local": index.n_local, "n_total": index.n_total,
        "similarity": str(index.sim.value), "sq4": index.search_providers is not None, "shards": files,
    })


def _write_manifest(directory: str, manifest: dict) -> None:
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def sharded_build_on_disk(
    directory: str | os.PathLike,
    vectors,
    n: int,
    dim: int,
    shards: int,
    config: GraphConfig | None = None,
    sim: SimilarityFunction | str = SimilarityFunction.EUCLIDEAN,
    training_sample: int = 65_536,
    seed: int = 0,
    checkpoint_every: int = 0,
    device: torch.device | str | None = None,
) -> dict:
    """Stream-build one larger-than-memory shard container per partition.

    The corpus is block-partitioned into ``shards`` contiguous ranges; each
    range is built by :func:`jvector_tpu_torch.disk.ltm.build_on_disk_ltm`
    on ``device`` (default: the card) into ``shard%04d.jvtpu``, and a
    manifest makes the directory loadable by :func:`load_sharded` (device
    serving) and ``ShardedHostIndex.load`` (bounded-memory host serving).
    The shards build one after another; they share nothing, so separate
    hosts could build them apart.

    Restartable at two levels: shards whose containers are committed (a
    valid footer) are skipped, and the shard in progress resumes from its
    own wave checkpoint.  Each shard trains its own quantizer on its range
    (seed ``seed + s``), so every shard file stands alone; merged serving
    reranks exactly, so scores compare across shards without a shared
    codebook.

    ``vectors`` is an array or a chunk loader ``f(start, stop)``.  Returns
    the manifest.
    """
    sim = SimilarityFunction.parse(sim)
    config = config or GraphConfig()
    directory = os.fspath(directory)
    os.makedirs(directory, exist_ok=True)
    load = (lambda a, b: vectors[a:b]) if isinstance(vectors, np.ndarray) else vectors
    n_local = -(-n // shards)
    # one capacity for every shard (the ragged last too): equal-shaped
    # containers stack in load_sharded
    cap = bucket_capacity(n_local)
    files = []
    for s in range(shards):
        a, b = s * n_local, min((s + 1) * n_local, n)
        fname = f"shard{s:04d}.jvtpu"
        fpath = os.path.join(directory, fname)
        files.append(fname)
        try:
            if IndexFileReader(fpath).meta.get("ltm"):
                continue  # committed in an earlier run
        except (OSError, ValueError):
            pass  # missing or unfinished: (re)build it
        build_on_disk_ltm(
            fpath, lambda i, j, a=a: load(a + i, a + j), n=b - a, dim=dim, config=config, sim=sim,
            training_sample=training_sample, seed=seed + s, compression="sq4", capacity=cap,
            checkpoint_every=checkpoint_every, device=device,
        )
    manifest = {
        "version": 1, "n_shards": shards, "n_local": n_local, "n_total": n, "similarity": str(sim.value),
        "sq4": True, "ltm": True, "shards": files,
    }
    _write_manifest(directory, manifest)
    return manifest


def _union_reencode(vecs, nbrs, scales, offsets, sim, devices, chunk: int = 65_536):
    """One affine for shards trained apart: the union of every shard's
    range (lo = min offset, hi = max offset + 15 * scale, since one shard's
    affine would clip drifted shards), every shard re-encoded with it and
    its fused tables rebuilt from its adjacency, in chunks (a whole shard at
    once would materialise an ``[n, R, MP]`` intermediate).  The shard files
    are untouched.  Returns ``(scale, offset, codes, consts, fused_packed,
    fused_w2)``, the last four per shard as numpy."""
    lo = np.minimum.reduce(offsets)
    hi = np.maximum.reduce([o + 15.0 * s for s, o in zip(scales, offsets)])
    offset = lo.astype(np.float32)
    scale = np.maximum((hi - lo) / 15.0, 1e-12).astype(np.float32)
    out = ([], [], [], [])
    for v, nb, dev in zip(vecs, nbrs, devices):
        sq = ScalarQuantization4(scale=torch.as_tensor(scale, device=dev), offset=torch.as_tensor(offset, device=dev),
                                 original_dim=int(v.shape[1]))
        codes, consts = [], []
        for st in range(0, v.shape[0], chunk):
            cb = sq.encode(np.asarray(v[st : st + chunk]))
            w2, norm2 = sq.node_constants(cb)
            codes.append(cb.cpu().numpy())
            consts.append((norm2 if sim == SimilarityFunction.COSINE else w2).cpu().numpy())
        codes, const = np.concatenate(codes), np.concatenate(consts)
        cap, r = nb.shape
        fused_p = np.zeros((cap, r * codes.shape[1]), np.uint8)
        fused_w = np.zeros((cap, r), np.float32)
        for st in range(0, cap, chunk):
            blk = nb[st : st + chunk]
            ok = blk >= 0
            safe = np.maximum(blk, 0)
            fused_p[st : st + chunk] = np.where(ok[..., None], codes[safe], 0).reshape(blk.shape[0], -1)
            fused_w[st : st + chunk] = np.where(ok, const[safe], 0.0)
        for acc, x in zip(out, (codes, const, fused_p, fused_w)):
            acc.append(x)
    return (scale, offset) + out


def load_sharded(directory: str | os.PathLike, mesh: Mesh, axis: str = "shard") -> ShardedIndex:
    """Reopen a sharded directory (:func:`save_sharded` or
    :func:`sharded_build_on_disk`, by either package) onto a mesh, shard
    ``s`` on ``mesh.devices[s]``.  L0 reads go through the version
    dispatch, so shards in the v3 paired layout load too."""
    directory = os.fspath(directory)
    with open(os.path.join(directory, "manifest.json")) as f:
        man = json.load(f)
    if man["n_shards"] != mesh.size:
        raise ValueError(f"manifest has {man['n_shards']} shards, mesh has {mesh.size}")
    sim = SimilarityFunction.parse(man["similarity"])
    f4 = f"feature/{FeatureId.FUSED_SQ4}"
    keys = ("codes_packed", "node_const", "fused_packed", "fused_w2", "scale", "offset")
    shards = []
    for fname in man["shards"]:
        idx = load_index(os.path.join(directory, fname))
        r = idx.reader
        nb = _read_l0_neighbors(r)
        sh = dict(
            neighbors=nb,
            counts=np.asarray(r.read("graph/L0/counts")),
            scores=(np.asarray(r.read("graph/L0/scores")) if r.has_array("graph/L0/scores")
                    else np.where(nb >= 0, 0.0, -np.inf).astype(np.float32)),
            deleted=(np.asarray(r.read("graph/deleted")) if r.has_array("graph/deleted")
                     else np.zeros(nb.shape[0], bool)),
            entry=int(idx.meta["entry_node"]),
            num=int(idx.meta["num_nodes"]),
            vectors=np.asarray(r.read(f"feature/{FeatureId.INLINE_VECTORS}/vectors")),
        )
        if man.get("sq4"):
            sh.update({k: np.asarray(r.read(f"{f4}/{k}")) for k in keys})
        shards.append(sh)

    # shard containers are padded to one capacity; a ragged shard's inline
    # vectors are the only per-n array: pad them to line up with the graph
    cap = shards[0]["neighbors"].shape[0]
    for sh in shards:
        v = sh["vectors"]
        if v.shape[0] != cap:
            sh["vectors"] = np.concatenate([v, np.zeros((cap - v.shape[0], v.shape[1]), v.dtype)])

    if man.get("sq4") and not all(
        np.array_equal(shards[0]["scale"], sh["scale"]) and np.array_equal(shards[0]["offset"], sh["offset"])
        for sh in shards
    ):
        # sharded_build_on_disk trains a quantizer per shard; one mesh
        # index needs one affine (load-time cost only; the host tier keeps
        # each shard's own quantizer)
        scale, offset, *tables = _union_reencode(
            [sh["vectors"] for sh in shards], [sh["neighbors"] for sh in shards],
            [sh["scale"] for sh in shards], [sh["offset"] for sh in shards], sim, mesh.devices,
        )
        for s, sh in enumerate(shards):
            sh.update(zip(("codes_packed", "node_const", "fused_packed", "fused_w2"), (t[s] for t in tables)))
            sh["scale"], sh["offset"] = scale, offset

    graphs, providers, search_providers = [], [], []
    for sh, dev in zip(shards, mesh.devices):
        def put(x, dev=dev):
            return torch.as_tensor(np.array(x), device=dev)

        graphs.append(GraphIndex(
            layers=(GraphLayer(neighbors=put(sh["neighbors"]), scores=put(sh["scores"]), counts=put(sh["counts"])),),
            level_node_ids=(),
            entry_node=torch.tensor(sh["entry"], dtype=torch.int32, device=dev),
            num_nodes=torch.tensor(sh["num"], dtype=torch.int32, device=dev),
            deleted=put(sh["deleted"]),
        ))
        providers.append(ExactScoreProvider(vectors=put(sh["vectors"]), sim=sim))
        if man.get("sq4"):
            # both per-node constants are functions of the codes: recompute
            # them (node_const stays on disk for the host tier)
            sq = ScalarQuantization4(scale=put(sh["scale"]), offset=put(sh["offset"]),
                                     original_dim=int(sh["vectors"].shape[1]))
            codes = put(sh["codes_packed"])
            w2, norm2 = sq.node_constants(codes)
            search_providers.append(SQ4ScoreProvider(
                codes_packed=codes, node_w2=w2, node_norm2=norm2, fused_packed=put(sh["fused_packed"]),
                fused_w2=put(sh["fused_w2"]), scale=sq.scale, offset=sq.offset,
                codes_aug=sq4_aug_rows(codes, put(sh["node_const"])), sim=sim,
            ))
    return ShardedIndex(
        graphs=graphs, providers=providers, n_shards=man["n_shards"], n_local=man["n_local"],
        n_total=man["n_total"], search_providers=search_providers if man.get("sq4") else None, sim=sim,
    )
