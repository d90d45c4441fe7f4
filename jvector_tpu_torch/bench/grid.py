"""Grid benchmark engine and YAML front end (counterpart of
``jvector_tpu/bench/grid.py``).

Reference: ``jvector-examples/.../Grid.java`` (build an index per
configuration, evaluate a topK x overquery grid) and ``BenchYAML`` (the
``yaml-configs/index-parameters/default.yml`` schema).  The YAML parameter
names are the reference's: ``construction.outDegree/efConstruction/
neighborOverflow/addHierarchy/compression(type PQ|BQ, m|mFactor, k,
anisotropicThreshold)``, ``search.compression``, ``search.topKOverquery``
and reranking.  Rows carry the JAX package's keys, with ``torch_version``
where it writes ``jax_version``.  Everything runs on ``device`` (the card
unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import time
from typing import Any

import numpy as np
import torch

from jvector_tpu_torch.bench.metrics import AccuracyMetrics, LatencyStats
from jvector_tpu_torch.util.datasets import DataSet
from jvector_tpu_torch.util.device import resolve_device


@dataclasses.dataclass
class GridConfig:
    out_degree: list[int] = dataclasses.field(default_factory=lambda: [32])
    ef_construction: list[int] = dataclasses.field(default_factory=lambda: [100])
    neighbor_overflow: list[float] = dataclasses.field(default_factory=lambda: [1.2])
    add_hierarchy: list[bool] = dataclasses.field(default_factory=lambda: [True])
    refine_final_graph: list[bool] = dataclasses.field(default_factory=lambda: [False])
    compression: list[dict | None] = dataclasses.field(
        default_factory=lambda: [None]
    )  # e.g. {"type": "PQ", "mFactor": 8, "k": 256, "anisotropicThreshold": -1.0}
    # search-time compression apart from construction (reference YAML
    # ``search.compression``): None -> serve with the construction entry; a
    # list -> the full product of build x serve compression
    search_compression: list[dict | None] | None = None
    reranking: list[str] = dataclasses.field(default_factory=lambda: ["FP32"])
    top_k_overquery: dict[int, list[float]] = dataclasses.field(
        default_factory=lambda: {10: [1.0, 2.0, 5.0, 10.0], 100: [1.0, 2.0]}
    )
    wave_size: int = 1024

    @staticmethod
    def from_yaml_dict(y: dict) -> "GridConfig":
        c = y.get("construction", {})
        s = y.get("search", {})
        comp = c.get("compression") or [None]
        comp = [None if x in (None, "none") else x for x in comp]
        scomp = s.get("compression")
        if scomp is not None:
            scomp = [None if x in (None, "none") else x for x in scomp]
        tko = {int(k): [float(v) for v in vs] for k, vs in (s.get("topKOverquery") or {10: [2.0]}).items()}
        return GridConfig(
            out_degree=[int(x) for x in c.get("outDegree", [32])],
            ef_construction=[int(x) for x in c.get("efConstruction", [100])],
            neighbor_overflow=[float(str(x).rstrip("f")) for x in c.get("neighborOverflow", [1.2])],
            add_hierarchy=[bool(x) for x in c.get("addHierarchy", [True])],
            refine_final_graph=[bool(x) for x in c.get("refineFinalGraph", [False])],
            compression=comp,
            search_compression=scomp,
            reranking=[str(x) for x in c.get("reranking", ["FP32"])],
            top_k_overquery=tko,
        )


def _pq_params(comp: dict, dim: int, aniso: bool = True) -> dict:
    """A PQ entry's cache-key parameters (the JAX package's key)."""
    m = comp.get("m") or max(1, dim // int(comp.get("mFactor", 8)))
    return {"m": int(m), "k": int(comp.get("k", 256)), "center": bool(comp.get("centerData", False)),
            "aniso": float(comp.get("anisotropicThreshold", -1.0)) if aniso else -1.0}


class Grid:
    """Build and evaluate every configuration over a dataset.

    ``compressor_cache_dir`` turns on the trained-compressor cache across
    rows and runs (the reference Grid's pqCacheDir with its atomic commit):
    an identical (dataset, compressor config) key loads instead of training.
    """

    def __init__(
        self,
        dataset: DataSet,
        config: GridConfig,
        compressor_cache_dir: str | None = None,
        device: torch.device | str | None = None,
    ):
        self.dataset = dataset
        self.config = config
        self.device = resolve_device(device)
        self.rows: list[dict[str, Any]] = []
        self._cache = None
        if compressor_cache_dir:
            from jvector_tpu_torch.quantization import CompressorCache

            self._cache = CompressorCache(compressor_cache_dir, device=self.device)

    # -- internals -----------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _trained(self, kind: str, params: dict, train):
        """Train a compressor, through the cache when one is configured."""
        if self._cache is None:
            return train()
        ds = self.dataset
        key = {"dataset": ds.name, "n": int(ds.base.shape[0]), "dim": int(ds.base.shape[1]), "kind": kind, **params}
        return self._cache.get_or_train(key, train)

    def _pq(self, params: dict):
        from jvector_tpu_torch.quantization import ProductQuantization

        return self._trained("pq", params, lambda: ProductQuantization.compute(
            self.dataset.base, m=params["m"], clusters=params["k"], globally_center=params["center"],
            anisotropic_threshold=params["aniso"], device=self.device))

    def _bq(self):
        from jvector_tpu_torch.quantization import BinaryQuantization

        return self._trained("bq", {}, lambda: BinaryQuantization.compute(self.dataset.base, device=self.device))

    def _build(self, out_degree, efc, overflow, hierarchy, refine=False, constr=None):
        """Build the graph; ``constr`` is the construction-time compression
        (the reference's pq/bqBuildScoreProvider choice).  None / "SQ4" take
        the default build (SQ4-searched, exact-pruned waves); "PQ" / "BQ"
        score construction with the compressed provider."""
        from jvector_tpu_torch.graph import ExactScoreProvider, GraphConfig, build_graph
        from jvector_tpu_torch.graph.builder import refine_graph
        from jvector_tpu_torch.graph.index import bucket_capacity
        from jvector_tpu_torch.ops.similarity import SimilarityFunction

        ds, dev = self.dataset, self.device
        ctype = None if constr is None else str(constr.get("type", "PQ")).upper()
        cfg = GraphConfig(max_degree=out_degree, ef_construction=efc, neighbor_overflow=overflow,
                          add_hierarchy=hierarchy)
        t0 = time.time()
        if ctype in (None, "NONE", "SQ4"):
            graph, provider = build_graph(ds.base, ds.similarity, cfg, device=dev)
        else:
            base = torch.as_tensor(ds.base, dtype=torch.float32, device=dev)
            n_cap = bucket_capacity(base.shape[0])

            def pad_rows(a):
                return torch.nn.functional.pad(a, (0, 0, 0, n_cap - a.shape[0]))

            if ctype == "PQ":
                pq = self._pq(_pq_params(constr, base.shape[1]))
                build_prov = pq.provider(pad_rows(pq.encode(base)), ds.similarity)
            elif ctype == "BQ":
                bq = self._bq()
                build_prov = bq.provider(pad_rows(bq.encode(base)))
            else:
                raise ValueError(f"unknown construction compression {ctype}")
            graph, _ = build_graph(ds.base, ds.similarity, cfg, provider=build_prov, device=dev)
            provider = ExactScoreProvider(vectors=pad_rows(base), sim=SimilarityFunction.parse(ds.similarity))
        if refine:
            graph = refine_graph(graph, provider, ds.base, cfg)
        self._sync()
        return graph, provider, time.time() - t0

    def _compression_provider(self, graph, graph_provider, comp: dict | None):
        ds = self.dataset
        if comp is None:
            return graph_provider, None, 0.0
        t0 = time.time()
        ctype = str(comp.get("type", "PQ")).upper()

        def pad_rows(codes):
            return torch.nn.functional.pad(codes, (0, 0, 0, graph.capacity - codes.shape[0]))

        if ctype == "PQ":
            pq = self._pq(_pq_params(comp, ds.dimension))
            prov = pq.provider(pq.encode(ds.base), ds.similarity)
        elif ctype == "BQ":
            bq = self._bq()
            prov = bq.provider(bq.encode(ds.base))
        elif ctype == "SQ4":
            from jvector_tpu_torch.quantization import ScalarQuantization4

            sq = self._trained("sq4", {}, lambda: ScalarQuantization4.compute(ds.base, device=self.device))
            aniso = float(comp.get("anisotropicThreshold", -1.0))
            codes = sq.encode_anisotropic(ds.base, threshold=aniso) if aniso > 0 else sq.encode(ds.base)
            prov = sq.provider_for_graph(pad_rows(codes), graph.base.neighbors, ds.similarity)
        elif ctype in ("FUSED_PQ", "FUSEDPQ"):
            from jvector_tpu_torch.graph import FusedADCScoreProvider, build_fused_codes
            from jvector_tpu_torch.ops.similarity import SimilarityFunction

            pq = self._pq(_pq_params(comp, ds.dimension, aniso=False))
            codes = pad_rows(pq.encode(ds.base))
            prov = FusedADCScoreProvider(codes=codes, fused_codes=build_fused_codes(graph.base.neighbors, codes),
                                         codebooks=pq.codebooks, center=pq.center,
                                         sim=SimilarityFunction.parse(ds.similarity))
        else:
            raise ValueError(f"unknown compression type {ctype}")
        self._sync()
        return prov, ctype, time.time() - t0

    def _reranker(self, exact_provider, kind: str):
        kind = kind.upper()
        if kind in ("FP32", "F32", "EXACT"):
            return exact_provider, 0.0
        if kind == "NVQ":
            from jvector_tpu_torch.quantization import NVQuantization

            t0 = time.time()
            nvq = self._trained("nvq", {}, lambda: NVQuantization.compute(self.dataset.base, device=self.device))
            prov = nvq.encode(self.dataset.base).provider(self.dataset.similarity)
            self._sync()
            return prov, time.time() - t0
        if kind in ("NONE", "OFF"):
            return None, 0.0
        raise ValueError(f"unknown reranking {kind}")

    # -- running the grid ------------------------------------------------------

    def run(self, verbose: bool = True) -> list[dict]:
        from jvector_tpu_torch.bench.diagnostics import run_metadata

        queries = torch.as_tensor(self.dataset.queries, dtype=torch.float32, device=self.device)
        cfg = self.config
        # run provenance on every row (reference GitInfo / SysInfoWriter)
        meta = run_metadata(config=dataclasses.asdict(cfg), device=self.device)
        provenance = {k: meta[k] for k in ("git_sha", "git_dirty", "device", "torch_version", "timestamp",
                                           "config_hash") if k in meta}
        for od, efc, ov, hier, refine, constr, rr in itertools.product(
            cfg.out_degree, cfg.ef_construction, cfg.neighbor_overflow, cfg.add_hierarchy,
            cfg.refine_final_graph, cfg.compression, cfg.reranking,
        ):
            graph, exact_provider, build_s = self._build(od, efc, ov, hier, refine, constr)
            # search.compression decouples serve-time compression from the
            # construction entry; unset, serve with the construction's
            serve_comps = cfg.search_compression if cfg.search_compression is not None else [constr]
            for comp in serve_comps:
                self._run_serve_rows(graph, exact_provider, build_s, od, efc, ov, hier, refine, constr, comp, rr,
                                     queries, provenance, verbose)
        return self.rows

    def _run_serve_rows(self, graph, exact_provider, build_s, od, efc, ov, hier, refine, constr, comp, rr,
                        queries, provenance, verbose):
        from jvector_tpu_torch.graph import search

        ds = self.dataset
        cfg = self.config
        first_pass, ctype, quant_s = self._compression_provider(graph, exact_provider, comp)
        # a reranker means something even without first-pass compression
        # (an exact first pass + NVQ rerank); only an exact rerank of an
        # exact first pass is redundant and skipped
        rr_redundant = comp is None and rr.upper() in ("FP32", "F32", "EXACT", "NONE", "OFF")
        reranker, rerank_quant_s = (None, 0.0) if rr_redundant else self._reranker(exact_provider, rr)

        for top_k, oqs in cfg.top_k_overquery.items():
            for oq in oqs:
                beam = max(int(top_k * oq), top_k)
                w = min(cfg.wave_size, queries.shape[0])
                waves = [queries[i : i + w] for i in range(0, queries.shape[0] - w + 1, w)]

                def run1(q):
                    return search(graph, first_pass, q, top_k=top_k, beam_width=beam,
                                  rerank_k=beam if reranker is not None else None, reranker=reranker)

                run1(waves[0])  # warm-up
                self._sync()
                secs, sizes, all_ids, visited = [], [], [], []
                for qv in waves:
                    t0 = time.time()
                    r = run1(qv)
                    self._sync()
                    secs.append(time.time() - t0)
                    sizes.append(qv.shape[0])
                    all_ids.append(r.ids.cpu().numpy())
                    visited.append(r.visited_count.cpu().numpy())
                ids = np.concatenate(all_ids, axis=0)
                n_eval = min(ids.shape[0], ds.ground_truth.shape[0])
                acc = AccuracyMetrics.compute(ids[:n_eval], ds.ground_truth, min(top_k, ds.ground_truth.shape[1]))
                lat = LatencyStats.compute(secs, sizes)
                row = {
                    "dataset": ds.name,
                    "outDegree": od,
                    "efConstruction": efc,
                    "neighborOverflow": ov,
                    "addHierarchy": hier,
                    "refineFinalGraph": refine,
                    "buildCompression": str(constr.get("type", "PQ")).upper() if constr else "NONE",
                    "compression": ctype or "NONE",
                    "reranking": rr if reranker is not None else "NONE",
                    "topK": top_k,
                    "overquery": oq,
                    "recall": round(acc.recall, 4),
                    "MAP": round(acc.map, 4),
                    "qps_avg": round(lat.qps_avg, 1),
                    "qps_median": round(lat.qps_median, 1),
                    "qps_max": round(lat.qps_max, 1),
                    "latency_avg_ms": round(lat.avg_ms, 2),
                    "latency_std_ms": round(lat.std_ms, 2),
                    "latency_p999_ms": round(lat.p999_ms, 2),
                    "mean_visited": round(float(np.mean(np.concatenate(visited))), 1),
                    "index_build_time_s": round(build_s, 2),
                    "quant_time_s": round(quant_s + rerank_quant_s, 2),
                    **provenance,
                }
                self.rows.append(row)
                if verbose:
                    print(json.dumps(row))
        return self.rows

    # -- reporting (reference ExperimentsCsvWriter / JsonlWriter) --------------

    def write_csv(self, path: str) -> None:
        import csv

        if not self.rows:
            return
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(self.rows[0]))
            w.writeheader()
            w.writerows(self.rows)

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for row in self.rows:
                f.write(json.dumps(row) + "\n")


def _report_stem(out_dir: str) -> str:
    """A report name of the second's stamp that no report in ``out_dir``
    has yet: ``experiments-<stamp>``, else ``experiments-<stamp>-<k>``.
    The name is claimed by creating its JSONL exclusively, so two runs that
    finish in one second keep both pairs."""
    stamp = time.strftime("%Y%m%dT%H%M%S")
    for k in itertools.count():
        stem = f"experiments-{stamp}" + (f"-{k}" if k else "")
        if os.path.exists(os.path.join(out_dir, f"{stem}.csv")):
            continue
        try:
            open(os.path.join(out_dir, f"{stem}.jsonl"), "x").close()
        except FileExistsError:
            continue
        return stem


def run_yaml(yaml_path: str, dataset: DataSet, out_dir: str | None = None,
             device: torch.device | str | None = None) -> list[dict]:
    """BenchYAML's counterpart: load a reference-schema YAML (read by
    ``util.yaml_subset``) and run the grid on ``device``; with ``out_dir``,
    write the rows as one CSV + JSONL pair of its own."""
    from jvector_tpu_torch.util import yaml_subset

    grid = Grid(dataset, GridConfig.from_yaml_dict(yaml_subset.load_file(yaml_path)), device=device)
    rows = grid.run()
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        stem = _report_stem(out_dir)
        grid.write_csv(os.path.join(out_dir, f"{stem}.csv"))
        grid.write_jsonl(os.path.join(out_dir, f"{stem}.jsonl"))
    return rows
