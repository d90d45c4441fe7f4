"""Where the time goes in the PyTorch/CUDA port, on one CUDA device.

    python experiments/torch_profile_build.py --n 200000                    # the SQ4 path
    python experiments/torch_profile_build.py --n 200000 --config default   # JVector's default config

Prints one JSON line per measurement:

1. the build of ``synthetic_dataset(n, 128)`` with host timers around each
   wave phase, each bracketed by a device sync, and the beam loop's step
   counts per wave search.  ``sq4``: ``GraphConfig(max_degree=32,
   ef_construction=100)``, phases ``_wave_search``, ``_wave_update_compute``,
   ``_wave_apply_packed``, ``packed_cleanup``.  ``default``: the same with
   overflow 1.2 and the hierarchy, built on PQ (M=16, K=256, uncentered),
   phases ``_wave_search``, ``_wave_update_plain``, ``_enforce_chunk``
   (the hierarchy's SQ4 sub-builds count into ``_wave_search``);
2. the device busy share of a fresh 20-wave build (``torch.profiler``:
   the sum of CUDA kernel self time over the wall time);
3. the same for one 4096-query two-pass search wave (SQ4 with the
   repacked tail at beams 100 and 30, or PQ-ADC at beams 100 and 20) on
   the graph of step 1, with recall@10 and the top device kernels.

The synced timers serialise host and device, so step 1's total is slower
than an untimed build; use its shares, not its sum.  Ends with the card's
name and power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from jvector_tpu_torch.graph import ExactScoreProvider, GraphConfig, search  # noqa: E402
from jvector_tpu_torch.graph import builder as tb  # noqa: E402
from jvector_tpu_torch.graph.index import bucket_capacity  # noqa: E402
from jvector_tpu_torch.quantization import ProductQuantization, ScalarQuantization4  # noqa: E402
from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset  # noqa: E402

CONFIGS = {
    "sq4": (
        GraphConfig(max_degree=32, ef_construction=100),
        ("_wave_search", "_wave_update_compute", "_wave_apply_packed", "packed_cleanup"),
    ),
    "default": (
        GraphConfig(max_degree=32, ef_construction=100, neighbor_overflow=1.2, add_hierarchy=True),
        ("_wave_search", "_wave_update_plain", "_enforce_chunk"),
    ),
}


def _busy(prof, wall: float, top: int = 12) -> dict:
    ka = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in ka if str(e.device_type).endswith("CUDA"))
    rows = sorted(ka, key=lambda e: e.self_device_time_total, reverse=True)[:top]
    return {
        "wall_s": wall,
        "device_busy_s": dev_us / 1e6,
        "busy_share": dev_us / 1e6 / wall,
        "top_device_ms": [(e.key[:60], e.self_device_time_total / 1e3, e.count) for e in rows],
    }


def _pq_provider(base: torch.Tensor):
    """The default config's PQ (M=16, K=256, uncentered) and its build
    provider, codes padded to the capacity."""
    pq = ProductQuantization.compute(base, m=16, clusters=256, globally_center=False)
    codes = pq.encode(base)
    pad = bucket_capacity(base.shape[0]) - base.shape[0]
    return pq, codes, pq.provider(torch.nn.functional.pad(codes, (0, 0, 0, pad)), "euclidean")


def timed_build(base: torch.Tensor, cfg: GraphConfig, phases: tuple, provider=None):
    """Build with synced host timers around each wave phase."""
    acc: dict[str, float] = {}
    steps: list[int] = []
    saved = {name: getattr(tb, name) for name in (*phases, "search_layer")}

    def timer(name, fn):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t
            return out

        return wrapped

    def counted_search(*a, **k):
        state = saved["search_layer"](*a, **k)
        steps.append(int(state.iters))
        return state

    for name in phases:
        setattr(tb, name, timer(name, saved[name]))
    tb.search_layer = counted_search
    try:
        t = time.time()
        graph, exact = tb.build_graph(base, "euclidean", cfg, provider=provider)
        torch.cuda.synchronize()
        build_s = time.time() - t
    finally:
        for name, fn in saved.items():
            setattr(tb, name, fn)
    return graph, exact, {
        "build_s": build_s,
        "phases_s": acc,
        "phase_shares": {k: v / build_s for k, v in acc.items()},
        "waves": len(steps),
        "wave_search_steps_mean": float(np.mean(steps)),
        "wave_search_steps_max": int(np.max(steps)),
    }


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=200_000, help="corpus size")
    p.add_argument("--config", choices=sorted(CONFIGS), default="sq4")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    n = args.n
    cfg, phase_names = CONFIGS[args.config]
    ds = synthetic_dataset(n=n, dim=128, n_queries=4096, k=10, n_clusters=max(64, n // 500), seed=0, device=dev)
    base = torch.as_tensor(ds.base, device=dev)
    pq = codes = None
    if args.config == "default":
        pq, codes, build_prov = _pq_provider(base)
    else:
        build_prov = None

    graph, exact, phases = timed_build(base, cfg, phase_names, build_prov)
    print(json.dumps({"config": args.config, "n": n, **phases}), flush=True)

    sub = base[: cfg.wave_size * 20]
    sub_prov = _pq_provider(sub)[2] if args.config == "default" else None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        tb.build_graph(sub, "euclidean", cfg, provider=sub_prov)
        torch.cuda.synchronize()
        wall = time.time() - t
    print(json.dumps({"window": f"{args.config} build of 20 waves (n={sub.shape[0]})", **_busy(prof, wall)}), flush=True)

    queries = torch.as_tensor(ds.queries, device=dev)
    if args.config == "default":
        exact = ExactScoreProvider(vectors=torch.nn.functional.pad(base, (0, 0, 0, graph.capacity - n)))
        first, beams, repack = pq.provider(codes, "euclidean"), (100, 20), False
    else:
        sq = ScalarQuantization4.compute(base)
        sq_codes = torch.nn.functional.pad(sq.encode(base), (0, 0, 0, graph.capacity - n))
        first, beams, repack = sq.provider_for_graph(sq_codes, graph.base.neighbors, "euclidean"), (100, 30), True
    for beam in beams:

        def run():
            return search(graph, first, queries, top_k=10, beam_width=beam, rerank_k=beam,
                          reranker=exact, repack_after=max(8, int(1.6 * beam)) if repack else 0)

        run()  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.time()
            res = run()
            torch.cuda.synchronize()
            wall = time.time() - t
        print(json.dumps({
            "window": f"{args.config} search wave Q={queries.shape[0]} beam {beam} (n={n})",
            "recall": recall_at_k(res.ids.cpu().numpy(), ds.ground_truth, 10),
            "expanded_mean": float(res.expanded_count.float().mean()),
            **_busy(prof, wall),
        }), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
