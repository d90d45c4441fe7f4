"""On a CUDA device, the beam loop's spans under the profiler: every call
in a search that synchronises with the device happens inside a
``beam.stop_test`` span, so ``beam.step`` spans time the host's issue of a
step and nothing else.

One BQ wave (beam 90, no repack) and one SQ4 wave (beam 30), the
benchmark cells' serving parameters, over a graph of 2,048 x 100, run
with ``torch.cuda.set_sync_debug_mode("warn")``; each warning it raises
is tagged with the spans open at that moment.  The SQ4 wave repacks its
tail after 16 steps, not the cell's 48, so that at this size the
narrower tail surely steps: the test asserts that it did.  This file imports no
JAX, so on the GPU host it runs alone:

    python -m pytest --noconftest -q tests/test_torch_tracing_cuda.py
"""

import warnings

import pytest
import torch

from jvector_tpu_torch import BinaryQuantization, GraphConfig, ScalarQuantization4, build_graph, tracing
from jvector_tpu_torch.graph.searcher import search

N, DIM, Q = 2048, 100, 256
REPACK_AFTER = 16


@pytest.fixture(scope="module")
def cuda_index():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sync debug mode watches CUDA calls)")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(18)
    centers = torch.randn(32, DIM, generator=g) * 4
    data = centers[torch.randint(0, 32, (N + Q,), generator=g)] + torch.randn(N + Q, DIM, generator=g)
    base, queries = data[:N].to(dev), data[N:].to(dev)
    graph, exact = build_graph(base, "euclidean", GraphConfig(max_degree=32, ef_construction=100, wave_size=512),
                               device=dev)
    bq = BinaryQuantization.compute(base)
    bq_first = bq.provider(bq.encode(base))
    sq = ScalarQuantization4.compute(base)
    codes = torch.nn.functional.pad(sq.encode(base), (0, 0, 0, graph.capacity - N))
    sq_first = sq.provider_for_graph(codes, graph.base.neighbors, "euclidean")
    return {
        "bq": lambda: search(graph, bq_first, queries, top_k=10, beam_width=90, rerank_k=90, reranker=exact),
        "sq4": lambda: search(graph, sq_first, queries, top_k=10, beam_width=30, rerank_k=30, reranker=exact,
                              repack_after=REPACK_AFTER),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bq", "sq4"])
def test_only_the_stop_test_synchronises(cuda_index, kind):
    cuda_index[kind]().ids.cpu()  # warm: first calls allocate and load
    torch.cuda.synchronize()
    seen = []  # (message and where it was raised, names of the spans open then, innermost last)

    def tag(message, category, filename, lineno, *args, **kwargs):
        seen.append((f"{filename}:{lineno}: {message}", [s.name for s in getattr(tracing._local, "stack", [])]))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = tag
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with torch.profiler.profile(activities=acts):
                cuda_index[kind]()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    in_search = [(m.splitlines()[0], open_) for m, open_ in seen if "synchroniz" in m and open_[:1] == ["search"]]
    assert in_search, "the stop test reads the device: the sync debug mode should see it"
    outside = [(m, open_) for m, open_ in in_search if open_[-1] != "beam.stop_test"]
    assert outside == [], outside
    w = tracing.last_window()
    stops = [s for s in w.spans if s.name == "beam.stop_test"]
    assert len(in_search) >= len(stops) > 0
    if kind == "sq4":  # the tail stepped, on fewer lanes than the wave
        steps = sum(s.name == "beam.step" for s in w.spans)
        assert steps > REPACK_AFTER
        assert REPACK_AFTER * Q < w.counters["beam.lane_slots"] < steps * Q
