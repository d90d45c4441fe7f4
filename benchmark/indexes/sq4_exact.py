"""Serve an SQ4 index: the SQ4 fused first pass, then the exact float32
rerank of the beam (``bench/headline.py::run_sq4``, the main path).

Set up through the port's public API: ``ScalarQuantization4.compute`` /
``encode`` / ``provider_for_graph`` over the built graph, and ``search``
with the exact provider that the build returned as reranker.

The control puts the reference in the program's place at the precision
below the configuration's (float32 with TF32 off): the exact search on
TF32-rounded inputs.  It needs no graph.
"""

from __future__ import annotations

import torch

from benchmark.reference import exact as reference

def prepare(graph, exact, base: torch.Tensor, cfg: dict, span):
    from jvector_tpu_torch import ScalarQuantization4, search

    sim, s = cfg["similarity"], cfg["serve"]
    with span("sq4.compute"):
        sq = ScalarQuantization4.compute(base)
    with span("sq4.encode"):
        codes = torch.nn.functional.pad(sq.encode(base), (0, 0, 0, graph.capacity - base.shape[0]))
    with span("sq4.provider_for_graph"):
        first = sq.provider_for_graph(codes, graph.base.neighbors, sim)

    def run(queries: torch.Tensor):
        return search(graph, first, queries, top_k=cfg["top_k"], beam_width=s["beam"], rerank_k=s["rerank_k"],
                      reranker=exact, repack_after=s["repack_after"])

    return run


def control(graph, exact, base: torch.Tensor, cfg: dict, span):
    return reference.control_search(base, cfg)
