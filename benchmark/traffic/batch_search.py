"""Traffic kind ``batch_search``: a closed loop of ``search`` calls.

Set-up makes the configuration's dataset (its base and its queries, the
same on every seed), builds the index (``build_graph``), sets up its serve
(the configuration's ``index``) and runs one warm-up wave of the window's
shape.  The seed orders the queries; the window then sends waves of
``wave`` queries, taken in turn from that order, one after another, each
complete when its ids and scores are on the host, until ``--seconds``
have passed and the last pass over the order is whole (where a wave is
the whole query set, every wave ends a pass); ``qps`` counts every query
of every wave over the whole window.  Each wave's host time goes into the
record, for the harness's ``waves (s)`` line.  A traced run profiles
``trace_waves`` waves after the first ``trace_after_waves``.

After the window every answer row is held to the reference
(``judge.answers``), once the index is freed.
"""

from __future__ import annotations

import time

import torch

from benchmark import corpus, judge
from benchmark.harness import GIB, Record


def run(ctx) -> Record:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    with ctx.spans("corpus"):
        data = corpus.make(cfg, dev)
    nq, w = data.queries.shape[0], tr["wave"]
    if nq % w:
        raise ValueError(f"a wave of {w} does not divide the {nq} queries of {cfg['name']}")
    g = torch.Generator(device=dev)
    g.manual_seed(ctx.seed)
    order = torch.randperm(nq, generator=g, device=dev)
    queries = data.queries[order]
    graph = exact = None
    if not ctx.control:  # the control is the reference: it needs no index
        from jvector_tpu_torch import build_graph

        with ctx.spans("build"):
            graph, exact = build_graph(data.base, cfg["similarity"], ctx.graph_config())
    serve = ctx.serve_fn(graph, exact, data.base)
    del graph, exact
    with ctx.spans("warm-up wave"):
        serve(queries[:w]).ids.cpu()
    if ctx.tracer is not None:
        ctx.tracer.warm()
    ctx.sync()
    setup_s = time.time() - ctx.t0
    ctx.reset_peak()

    chunks = nq // w
    rows, expanded, reranked = [], 0, 0
    first_traced = tr["trace_after_waves"] if ctx.tracer is not None else -1
    last_traced = first_traced + tr["trace_waves"] - 1 if ctx.tracer is not None else -1
    waves, wave_s = 0, []
    start = tick = time.perf_counter()
    while True:
        if waves == first_traced:
            ctx.tracer.start("serve")
        c = waves % chunks
        with ctx.spans("search wave"):
            res = serve(queries[c * w : (c + 1) * w])
            rows.append((c, res.ids.cpu(), res.scores.cpu()))
        expanded = expanded + res.expanded_count.sum()
        reranked = reranked + res.reranked_count.sum()
        if waves == last_traced:
            ctx.tracer.stop(ctx.sync)
        waves += 1
        now = time.perf_counter()
        wave_s.append((tick - start, now - tick))
        tick = now
        if now - start >= ctx.seconds and waves > last_traced and waves % chunks == 0:
            break
    window_s = tick - start
    window_peak = ctx.peak()
    counters = {"queries": waves * w, "expanded": int(expanded), "reranked": int(reranked), "waves": waves}
    del serve, res
    ctx.free()
    process_peak = ctx.process_peak()
    traces = {"serve": ctx.tracer.reduce()} if ctx.tracer is not None else {}

    qidx = torch.cat([order[c * w : (c + 1) * w] for c, _, _ in rows])
    ids = torch.cat([r[1] for r in rows]).to(dev)
    scores = torch.cat([r[2] for r in rows]).to(dev)
    numbers = judge.answers(data.base, data.queries, qidx, ids, scores, cfg["similarity"])
    return Record(
        end_to_end={"qps": waves * w / window_s, "recall_at_10": numbers["recall"],
                    "device_peak_gib": window_peak / GIB, "setup_s": setup_s},
        numbers=numbers, attempted=waves * w, failed=numbers["bad_rows"], memory_peak_bytes=process_peak,
        counters=counters, traces=traces, waves=wave_s)
