"""Serve a BQ index: the binary-quantized first pass (Hamming distances of
sign bits around the mean), then the exact float32 rerank of the beam.

Set up through the port's public API: ``BinaryQuantization.compute`` /
``encode`` / ``provider``, and ``search`` with the exact provider that
the build returned as reranker.

The control puts the reference in the program's place at the precision
below the configuration's (float32 with TF32 off): the exact search on
TF32-rounded inputs.  It needs no graph.
"""

from __future__ import annotations

import torch

from benchmark.reference import exact as reference

def prepare(graph, exact, base: torch.Tensor, cfg: dict, span):
    from jvector_tpu_torch import BinaryQuantization, search

    s = cfg["serve"]
    with span("bq.compute"):
        bq = BinaryQuantization.compute(base)
    with span("bq.encode"):
        first = bq.provider(bq.encode(base))

    def run(queries: torch.Tensor):
        return search(graph, first, queries, top_k=cfg["top_k"], beam_width=s["beam"], rerank_k=s["rerank_k"],
                      reranker=exact, repack_after=s["repack_after"])

    return run


def control(graph, exact, base: torch.Tensor, cfg: dict, span):
    return reference.control_search(base, cfg)
