"""Drive the PyTorch/CUDA port's paths once on one GPU.

    python3 chip_smoke.py              # the LTM path at 1M, the earlier paths at 200k
    python3 chip_smoke.py --n 50000    # a shorter rehearsal: every path at 50k

Phases, each printing one JSON line:

1. environment: torch / CUDA / nvcc versions and the card's name and power
   limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them; exits
   non-zero without a CUDA device;
2. kernel build: compiles ``jvector_tpu_torch/csrc/*.cu``, one nvcc per
   source, all started together;
3. kernel check: K1 (packed adjacency), K3 (packed adjacency without the
   w2 table) and K2 (fused SQ4 code table) against their plain PyTorch
   twins at the 1M build shapes (bit-exact, ``torch.equal``), and K5 (PQ
   ADC) against its twin at the build, serve, centroid-scan and an
   unaligned shape (``torch.allclose(rtol=1e-5,
   atol=1e-4)``: only the order of the float32 sum differs); each with the
   median time of 20 runs from CUDA events, beside its bound (bytes over
   3.35 TB/s) and, for K5, the gather + sum PyTorch computes it with;
4. SQ4 path (the flagship path, at ``min(--n, 200,000)``: cut from 1M so
   the script keeps its time with the LTM path added): ``build_graph`` at
   ``GraphConfig(max_degree=32, ef_construction=100)``, SQ4
   compute/encode/provider_for_graph, exact ground truth for 1024 queries,
   two-pass SQ4 + exact-rerank search in 4096-query waves at beam 100 and
   at the smallest beam of bench.py's list that clears recall 0.955.
   Fails if recall@10 at beam 100 is below 0.95 or if K1's or K2's launch
   count over the build differs from the number of build waves;
5. default configuration (upstream JVector's ``yaml-configs/default.yml``:
   outDegree 32, efConstruction 100, overflow 1.2, hierarchy, PQ
   construction and search with M = d/8 = 16, K = 256, no centering, FP32
   rerank, overquery 1/2/5/10), first at n = 20,000 (512 queries) against
   the JAX package's recall figures for that corpus, then at
   ``min(--n, 200,000)`` (cut from 1M, as the SQ4 path): PQ compute +
   encode, ``GraphIndexBuilder(...).build(..., provider=PQ)`` with the
   hierarchy (per-phase seconds from its ``on_phase``), ADC first pass + exact rerank at beams 10/20/50/100, and the
   fused PQ first pass at beam 100; QPS over >= 65,536 queries at beams 20
   and 100; an exact first pass at beam 100 over the same graph shows
   how far the PQ-scored graph itself bounds recall.  Fails if K5 was not
   launched in the build or in serving, if a result has fewer than 10 ids
   or non-finite scores, if the 20k recall differs from the JAX figures by
   more than 0.03, or, at n = 200,000, if recall@10 at beam 100 is below
   0.30 (the reference reaches 0.4065 there and 0.26 at 50k, where no
   floor holds);
6. LTM path (``--n``, the main path): the larger-than-memory
   stream build ``build_on_disk_ltm(compression="sq4",
   GraphConfig(max_degree=32, ef_construction=100, add_hierarchy=True))``
   of ``synthetic_dataset(n, dim=128, seed=0, n_clusters=n // 500)`` from
   a chunk loader over the host array (the corpus is never uploaded whole)
   into a temporary directory (~5.5 GB at 1M, deleted at the end), with
   ``ltm._FUSED_BUILD_BUDGET = 0`` so the base layer takes the packed
   regime (K3 once per wave); then ``HostGraphIndex.load`` serves 1024
   queries with exact ground truth at beam 64, expand 4, with the default
   host rerank; ``load_index(path).graph_to_device`` must give back the
   returned graph exactly; and a PQ stream build at n = 20,000 served
   through ``search_with_host_rerank`` is held to the JAX package's recall
   at beam 100 (``experiments/torch_ltm_pq_cpu.py``).  Fails if the regime
   is not packed, if K3's launches differ from the number of waves, if
   host-served recall@10 is below 0.90, if the round trip differs, or if
   the 20k PQ recall is more than 0.03 from the JAX figure.

The LTM path (6) runs right after the kernel check, then 4 and 5.  Kernel
launch counts are read per path: set to 0 just before a path, read just
after.  Float32 matrix products run in full float32: TF32 is switched
off for matmuls and cuDNN.  The run uses one card (``CUDA_VISIBLE_DEVICES``
is the first that ``CUDA_VISIBLE_DEVICES`` lists, else card 0).  Imports
nothing of JAX.  The last line is the JSON
``{"ok": true, "device": {...}}``; any failure raises before it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# one card, set before CUDA starts: the first the caller lists, else card 0
os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np  # noqa: E402
import torch  # noqa: E402

BEAMS = (20, 21, 22, 23, 25, 30, 35, 40, 50, 60, 80, 100, 150, 200)  # bench.py's list
RECALL_FLOOR = 0.95
HEADLINE_FLOOR = 0.955
TOP_K = 10
GT_QUERIES = 1024
WAVE = 4096
N_QUERIES = 8192  # two 4096-query waves, as bench.py's default
MIN_TIMED_QUERIES = 65_536
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
OVERQUERY = (1, 2, 5, 10)  # default.yml topKOverquery 10: beam = rerank_k = 10 * overquery
# recall@10 of the JAX package's default configuration on
# synthetic_dataset(n=20_000, dim=128, n_queries=512, k=10, n_clusters=64,
# seed=0), PQ M=16 K=256 uncentered, hierarchy, ADC first pass + FP32 rerank
JAX_RECALL_20K = {10: 0.1521, 20: 0.2412, 50: 0.3828, 100: 0.5066}
PARITY_SLACK = 0.03  # the port's k-means draws differ from jax.random's
SANITY_FLOOR_200K = 0.30  # recall@10 at beam 100 at n = 200k: catches a broken search (the JAX package: 0.4065)
EARLIER_N = 200_000  # the SQ4 and default-config paths' corpus, cut from 1M for the LTM path's time
# LTM path: host-served recall floor (tests/test_ltm.py's), serving knobs,
# and the JAX package's recall@10 of the PQ stream build on
# synthetic_dataset(n=20_000, dim=128, n_queries=512, k=10, n_clusters=64,
# seed=0), GraphConfig(max_degree=32, ef_construction=100), PQ M=16 K=256
# trained in the build, search_with_host_rerank at beam = rerank_k
# (experiments/torch_ltm_pq_cpu.py)
HOST_RECALL_FLOOR = 0.90
HOST_BEAM, HOST_EXPAND = 64, 4
LTM_PQ_N = 20_000
JAX_LTM_PQ_RECALL_20K = {10: 0.148046875, 20: 0.230078125, 50: 0.3650390625, 100: 0.493359375}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, reps: int = 20) -> float:
    """Median wall time of ``fn`` on the device, from CUDA events."""
    fn()  # warm-up
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_env() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    if torch.cuda.device_count() != 1:
        raise SystemExit(f"chip_smoke: {torch.cuda.device_count()} devices visible, the run uses one")
    from jvector_tpu_torch.ops.kernels._build import find_nvcc

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True, text=True, check=True)
    emit({
        "phase": "env",
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": nvcc.stdout.strip().splitlines()[-1],
        "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32, "cudnn": torch.backends.cudnn.allow_tf32},
    })
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    return smi


def phase_build() -> None:
    from jvector_tpu_torch.ops.kernels import _build, adc, packed_adj, scatter_rows

    t0 = time.time()
    sources = sorted(f for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        list(pool.map(_build.build, sources))
    for mod in (packed_adj, scatter_rows, adc):
        mod._lib()
    emit({"phase": "kernel_build", "sources": sources, "seconds": time.time() - t0})


def bound_ms(n_bytes: int) -> float:
    """Least time to move ``n_bytes`` through device memory, in ms."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def _k1_inputs(rng: np.random.Generator, dev, n_cap: int = 1_048_576):
    """K1 at the 1M main-path shapes: N_cap = 1,048,576 rows, W = 512,
    P = W*(M+1) = 16,896 patches sorted by row, with dropped rows, runs of
    several patches per physical row and enforce images."""
    w, m = 512, 32
    n_pr = n_cap // 8
    big = 2**30
    adj = torch.randint(-(2**31), 2**31 - 1, (n_pr, 8, 128), dtype=torch.int32, device=dev)
    w2t = torch.randint(-(2**31), 2**31 - 1, (n_pr, 8, 128), dtype=torch.int32, device=dev)
    a0 = int(rng.integers(0, n_pr - w // 8))
    a_rows = np.arange(a0, a0 + w // 8, dtype=np.int32)
    a_rows[3], a_rows[7] = -1, n_pr  # dropped
    # appends: distinct (row, slot) pairs, several per row; enforce images
    # on rows that take no append (the graph builder's contract)
    rows = rng.choice(n_cap, 8000 + w, replace=False).astype(np.int32)
    app_rows, er_rows = rows[:8000], rows[8000:]
    mult = rng.integers(1, 7, app_rows.size)
    keys, slots = [], []
    for r, k in zip(app_rows, mult):
        keys += [r] * int(k)
        slots += list(rng.permutation(64)[:k])
    n_app = w * m
    keys, slots = np.array(keys[:n_app], np.int32), np.array(slots[:n_app], np.int32)
    keys[rng.random(n_app) < 0.05] = big  # dropped appends
    er_key = er_rows.copy()
    er_key[rng.random(w) < 0.1] = big  # enforce rows not taken
    m_key = np.concatenate([keys, er_key])
    m_slot = np.concatenate([slots, np.zeros(w, np.int32)])
    m_img = np.concatenate([np.full(n_app, -1, np.int32), np.arange(w, dtype=np.int32)])
    order = np.argsort(m_key, kind="stable")
    m_key, m_slot, m_img = m_key[order], m_slot[order], m_img[order]
    prow = np.where(m_key < n_cap, m_key >> 3, big).astype(np.int32)
    p = m_key.size

    def t(x):
        return torch.as_tensor(x, device=dev)

    def rnd(*shape):
        return torch.randint(-(2**31), 2**31 - 1, shape, dtype=torch.int32, device=dev)

    args = (
        t(a_rows), rnd(w // 8, 8, 128), rnd(w // 8, 8, 128),
        t(prow), t((m_key & 7).astype(np.int32)), t(m_slot), rnd(p), rnd(p), rnd(p), t(m_img),
        rnd(w, 128), rnd(w, 128),
    )
    return adj, w2t, args


def _k2_inputs(rng: np.random.Generator, dev, n_cap: int = 1_048_576):
    """K2 at the 1M main-path shapes: a [1,048,576, 32, 128] uint8 table
    (4 KB rows, MP = 64), W = 512 wave images, W*M = 16,384 slot patches
    sorted by row (runs of several slots per row, dropped patches at run
    ends as the builder emits them) and W enforce images."""
    w, m, t3, mp = 512, 32, 32, 64
    table = torch.randint(0, 256, (n_cap, t3, 128), dtype=torch.uint8, device=dev)
    w0 = int(rng.integers(0, n_cap // w)) * w
    wave_rows = np.arange(w0, w0 + w, dtype=np.int32)
    wave_rows[5], wave_rows[9] = -1, n_cap
    rows = rng.choice(n_cap, 8000 + w, replace=False).astype(np.int32)
    p_targets, er_rows = np.sort(rows[:8000]), rows[8000:].copy()
    er_rows[rng.random(w) < 0.1] = -1
    keys, slots = [], []
    for r in p_targets:
        k = int(rng.integers(1, 7))
        run = [r] * k
        if rng.random() < 0.1:
            run[-1] = -1  # a dropped tail patch
        keys += run
        slots += list(rng.permutation(64)[:k])
    p = w * m
    keys, slots = np.array(keys[:p], np.int32), np.array(slots[:p], np.int32)

    def t(x):
        return torch.as_tensor(x, device=dev)

    args = (
        t(wave_rows), torch.randint(0, 256, (w, t3, 128), dtype=torch.uint8, device=dev),
        t(keys), t(slots), torch.randint(0, 256, (p, mp), dtype=torch.uint8, device=dev),
        t(er_rows), torch.randint(0, 256, (w, t3, 128), dtype=torch.uint8, device=dev),
    )
    return table, args


def _k1_bytes(adj: torch.Tensor, args: tuple) -> int:
    """K1's least traffic: every stream read once, every written id /
    score / w2 and image written once."""
    n_pr = adj.shape[0]
    a_rows, a_adj, a_w2, prow, _, _, _, _, _, img, e_adj, e_w2 = args
    read = sum(x.numel() * x.element_size() for x in args)
    ok = (prow >= 0) & (prow < n_pr)
    n_wave = int(((a_rows >= 0) & (a_rows < n_pr)).sum())
    n_app, n_img = int((ok & (img < 0)).sum()), int((ok & (img >= 0)).sum())
    return read + n_wave * 2 * a_adj[0].numel() * 4 + n_app * 3 * 4 + n_img * 2 * 128 * 4


def _k3_args(k1_args: tuple) -> tuple:
    """K3's arguments from a K1 case: the same streams without the w2 parts
    (at the 1M LTM path: N/8 = 131,072, Wa = 64, P = 16,896, E = 512)."""
    a_rows, a_adj, _, prow, sub, slot, p_id, p_sc, _, img, e_adj, _ = k1_args
    return a_rows, a_adj, prow, sub, slot, p_id, p_sc, img, e_adj


def _k3_bytes(adj: torch.Tensor, args: tuple) -> int:
    """K3's least traffic: every stream read once, every written id / score
    and image written once."""
    n_pr = adj.shape[0]
    a_rows, a_adj, prow, _, _, _, _, img, e_adj = args
    read = sum(x.numel() * x.element_size() for x in args)
    ok = (prow >= 0) & (prow < n_pr)
    n_wave = int(((a_rows >= 0) & (a_rows < n_pr)).sum())
    n_app, n_img = int((ok & (img < 0)).sum()), int((ok & (img >= 0)).sum())
    return read + n_wave * a_adj[0].numel() * 4 + n_app * 2 * 4 + n_img * 128 * 4


def _k2_bytes(table: torch.Tensor, args: tuple) -> int:
    """K2's least traffic: every stream read once, every written row image
    and slot written once."""
    n, row = table.shape[0], table[0].numel()
    wave_rows, _, patch_rows, _, patch_src, er_rows, _ = args
    read = sum(x.numel() * x.element_size() for x in args)

    def valid(r):
        return int(((r >= 0) & (r < n)).sum())

    return read + (valid(wave_rows) + valid(er_rows)) * row + valid(patch_rows) * patch_src.shape[1]


def _k5_inputs(gen: torch.Generator, q: int, c: int, m: int, k: int):
    dev = torch.device("cuda")
    luts = torch.rand((q, m, k), generator=gen, device=dev) * 50.0
    codes = torch.randint(0, k, (q, c, m), generator=gen, device=dev, dtype=torch.uint8)
    return luts, codes


def _k5_check(gen, q, c, m, k, timed: bool) -> dict:
    from jvector_tpu_torch.ops.adc import adc_score
    from jvector_tpu_torch.ops.kernels.adc import adc_score_kernel

    luts, codes = _k5_inputs(gen, q, c, m, k)
    got = adc_score_kernel(luts, codes)
    want = adc_score(luts, codes)
    torch.cuda.synchronize()
    row = {"shape": {"Q": q, "C": c, "M": m, "K": k},
           "allclose": bool(torch.allclose(got, want, rtol=1e-5, atol=1e-4)),
           "max_abs_err": float((got - want).abs().max()),
           "bytes": luts.numel() * 4 + codes.numel() + got.numel() * 4}
    row["bound_ms"] = bound_ms(row["bytes"])
    if timed:
        row["ms"] = median_ms(lambda: adc_score_kernel(luts, codes))
        row["plain_ms"] = median_ms(lambda: adc_score(luts, codes))
        row["library_ms"] = median_ms(lambda: torch.gather(luts, 2, codes.transpose(1, 2).long()).sum(1))
    return row


# K5 shapes: the serve and build-search shapes this path gives the kernel
# (R = 56 adjacency slots of the PQ-built base layer, E = 2 expansions per
# build step, 64 slots on the SQ4-built upper levels), the intra-wave and
# centroid-scan calls, and an unaligned shape (M not a multiple of 16, K < 256)
K5_SHAPES = {
    "serve": (4096, 56, 16, 256),
    "serve_fused_levels": (4096, 64, 16, 256),
    "build_search": (512, 112, 16, 256),
    "build_intra_wave": (512, 512, 16, 256),
    "centroid_scan": (1, 1_000_000, 16, 256),
    "unaligned": (13, 19, 5, 32),
}


def phase_kernel_check() -> list[dict]:
    from jvector_tpu_torch.ops.kernels.packed_adj import (
        packed_adj_only_update_inplace,
        packed_adj_only_update_ref,
        packed_adj_update_inplace,
        packed_adj_update_ref,
    )
    from jvector_tpu_torch.ops.kernels.scatter_rows import fused_update_inplace, fused_update_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(1234)
    out = []

    adj, w2t, args = _k1_inputs(rng, dev)
    ka, kw = adj.clone(), w2t.clone()
    packed_adj_update_inplace(ka, kw, *args)
    ra, rw = adj.clone(), w2t.clone()
    packed_adj_update_ref(ra, rw, *args)
    torch.cuda.synchronize()
    exact = torch.equal(ka, ra) and torch.equal(kw, rw)
    err = 0 if exact else max(
        int((ka.long() - ra.long()).abs().max()), int((kw.long() - rw.long()).abs().max())
    )
    changed = int((ka != adj).any(dim=(1, 2)).sum())
    ms = median_ms(lambda: packed_adj_update_inplace(ka, kw, *args))
    plain_ms = median_ms(lambda: packed_adj_update_ref(ra, rw, *args))
    n_bytes = _k1_bytes(adj, args)
    emit({"phase": "kernel_check", "kernel": "K1 packed_adj_update_inplace", "bit_exact": exact,
          "physical_rows_changed": changed, "ms": ms, "plain_ms": plain_ms, "bytes": n_bytes})
    if not exact or changed == 0:
        raise SystemExit("K1 disagrees with its twin")
    out.append({"name": "packed_adj_update_inplace", "route": "cuda",
                "source": "jvector_tpu_torch/csrc/packed_adj.cu",
                "replaces": "jvector_tpu/ops/pallas/packed_adj.py:364",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms(n_bytes), "bound_by": "bytes", "library_ms": None})
    del w2t, ka, kw, ra, rw

    args = _k3_args(args)
    ka = adj.clone()
    packed_adj_only_update_inplace(ka, *args)
    ra = adj.clone()
    packed_adj_only_update_ref(ra, *args)
    torch.cuda.synchronize()
    exact = torch.equal(ka, ra)
    err = 0 if exact else int((ka.long() - ra.long()).abs().max())
    changed = int((ka != adj).any(dim=(1, 2)).sum())
    ms = median_ms(lambda: packed_adj_only_update_inplace(ka, *args))
    plain_ms = median_ms(lambda: packed_adj_only_update_ref(ra, *args))
    n_bytes = _k3_bytes(adj, args)
    emit({"phase": "kernel_check", "kernel": "K3 packed_adj_only_update_inplace", "bit_exact": exact,
          "physical_rows_changed": changed, "ms": ms, "plain_ms": plain_ms, "bytes": n_bytes})
    if not exact or changed == 0:
        raise SystemExit("K3 disagrees with its twin")
    out.append({"name": "packed_adj_only_update_inplace", "route": "cuda",
                "source": "jvector_tpu_torch/csrc/packed_adj.cu",
                "replaces": "jvector_tpu/ops/pallas/packed_adj.py:501",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms(n_bytes), "bound_by": "bytes", "library_ms": None})
    del adj, ka, ra, args

    table, args = _k2_inputs(rng, dev)
    kt = table.clone()
    fused_update_inplace(kt, *args)
    rt = table.clone()
    fused_update_ref(rt, *args)
    torch.cuda.synchronize()
    exact = torch.equal(kt, rt)
    err = 0 if exact else int((kt.to(torch.int16) - rt.to(torch.int16)).abs().max())
    changed = int((kt != table).any(dim=(1, 2)).sum())
    ms = median_ms(lambda: fused_update_inplace(kt, *args))
    plain_ms = median_ms(lambda: fused_update_ref(rt, *args))
    n_bytes = _k2_bytes(table, args)
    emit({"phase": "kernel_check", "kernel": "K2 fused_update_inplace", "bit_exact": exact,
          "rows_changed": changed, "ms": ms, "plain_ms": plain_ms, "bytes": n_bytes})
    if not exact or changed == 0:
        raise SystemExit("K2 disagrees with its twin")
    out.append({"name": "fused_update_inplace", "route": "cuda",
                "source": "jvector_tpu_torch/csrc/fused_update.cu",
                "replaces": "jvector_tpu/ops/pallas/scatter_rows.py:426",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms(n_bytes), "bound_by": "bytes", "library_ms": None})
    del table, kt, rt, args
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(1234)
    rows = {name: _k5_check(gen, *shape, timed=name != "unaligned")
            for name, shape in K5_SHAPES.items()}
    emit({"phase": "kernel_check", "kernel": "K5 adc_score_kernel", "shapes": rows})
    bad = [name for name, r in rows.items() if not r["allclose"]]
    if bad:
        raise SystemExit(f"K5 disagrees with its twin at {bad}")
    serve = rows["serve"]
    out.append({"name": "adc_score_kernel", "route": "cuda",
                "source": "jvector_tpu_torch/csrc/adc.cu",
                "replaces": "jvector_tpu/ops/pallas/adc_kernel.py:63",
                "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
                "ms": serve["ms"], "plain_ms": serve["plain_ms"], "bound_ms": serve["bound_ms"],
                "bound_by": "bytes", "library_ms": serve["library_ms"]})
    torch.cuda.empty_cache()
    return out


def _counters() -> dict:
    from jvector_tpu_torch.ops.kernels import (
        adc_score_kernel,
        fused_update_inplace,
        packed_adj_only_update_inplace,
        packed_adj_update_inplace,
    )

    return {"packed_adj_update_inplace": packed_adj_update_inplace,
            "packed_adj_only_update_inplace": packed_adj_only_update_inplace,
            "fused_update_inplace": fused_update_inplace,
            "adc_score_kernel": adc_score_kernel}


def reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def _check_result(res, n_q: int, what: str) -> np.ndarray:
    ids, scores = res.ids.cpu().numpy(), res.scores.cpu().numpy()
    if ids.shape != (n_q, TOP_K) or not np.isfinite(scores[ids >= 0]).all():
        raise SystemExit(f"{what}: ids {ids.shape} or non-finite scores")
    if (ids < 0).any():
        raise SystemExit(f"{what}: fewer than {TOP_K} results")
    return ids


def _qps(run, queries: torch.Tensor) -> float:
    waves = [queries[i : i + WAVE] for i in range(0, queries.shape[0] - WAVE + 1, WAVE)]
    run(waves[0]).ids.cpu()  # warm-up
    timed = waves * max(1, -(-MIN_TIMED_QUERIES // (len(waves) * WAVE)))
    torch.cuda.synchronize()
    t = time.time()
    for wv in timed:
        run(wv)
    torch.cuda.synchronize()
    return len(timed) * WAVE / (time.time() - t)


def phase_sq4_path(n: int, dev: torch.device) -> dict:
    from jvector_tpu_torch.graph import GraphConfig, build_graph, search
    from jvector_tpu_torch.graph.builder import _shuffled_wave_starts
    from jvector_tpu_torch.quantization import ScalarQuantization4
    from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset

    cfg = GraphConfig(max_degree=32, ef_construction=100)
    t0 = time.time()
    ds = synthetic_dataset(n=n, dim=128, n_queries=N_QUERIES, k=TOP_K,
                           n_clusters=max(64, n // 500), seed=0, device=dev)
    base = torch.as_tensor(ds.base, device=dev)
    queries = torch.as_tensor(ds.queries, device=dev)
    gt = ds.ground_truth[:GT_QUERIES]
    torch.cuda.synchronize()
    data_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()  # the index's peak, not the ground truth's

    reset_counts()
    t0 = time.time()
    graph, exact = build_graph(base, "euclidean", cfg)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    n_waves = len(_shuffled_wave_starts(n, cfg.wave_size))

    t0 = time.time()
    sq = ScalarQuantization4.compute(base)
    codes = torch.nn.functional.pad(sq.encode(base), (0, 0, 0, graph.capacity - n))
    sq4 = sq.provider_for_graph(codes, graph.base.neighbors, "euclidean")
    torch.cuda.synchronize()
    encode_s = time.time() - t0

    def run(qs, beam):
        return search(graph, sq4, qs, top_k=TOP_K, beam_width=beam, rerank_k=beam,
                      reranker=exact, repack_after=max(8, int(1.6 * beam)))

    def recall(beam):
        ids = _check_result(run(queries[:GT_QUERIES], beam), GT_QUERIES, f"SQ4 search at beam {beam}")
        return recall_at_k(ids, gt, TOP_K)

    points = {}
    chosen = None
    for beam in BEAMS:
        r = recall(beam)
        points[beam] = {"recall": r}
        if r >= HEADLINE_FLOOR:
            chosen = beam
            break
    for beam in sorted({100, chosen or BEAMS[-1]}):
        if beam not in points:
            points[beam] = {"recall": recall(beam)}
        points[beam]["qps"] = _qps(lambda q, b=beam: run(q, b), queries)
    launches = read_counts()
    result = {
        "phase": "sq4_path", "n": n, "dim": 128, "n_waves": n_waves,
        "data_seconds": data_s, "build_seconds": build_s, "sq4_encode_seconds": encode_s,
        "average_degree": graph.average_degree(), "headline_beam": chosen,
        "beams": {str(b): v for b, v in sorted(points.items())}, "launches": launches,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(result)
    if points[100]["recall"] < RECALL_FLOOR:
        raise SystemExit(f"recall@10 at beam 100 is {points[100]['recall']} < {RECALL_FLOOR}")
    for name in ("packed_adj_update_inplace", "fused_update_inplace"):
        if launches[name] != n_waves:
            raise SystemExit(f"{name} launched {launches[name]} times over {n_waves} build waves")
    return result


def phase_default_config(n: int, dev: torch.device, n_queries: int, n_clusters: int, gt_queries: int,
                         timed_beams: tuple) -> dict:
    """Upstream JVector's default configuration end to end (see the module
    docstring); returns the result line."""
    from jvector_tpu_torch.graph import (
        ExactScoreProvider, FusedADCScoreProvider, GraphConfig, GraphIndexBuilder, build_fused_codes, search,
    )
    from jvector_tpu_torch.graph.index import bucket_capacity
    from jvector_tpu_torch.quantization import ProductQuantization
    from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset

    cfg = GraphConfig(max_degree=32, ef_construction=100, neighbor_overflow=1.2, add_hierarchy=True)
    t0 = time.time()
    ds = synthetic_dataset(n=n, dim=128, n_queries=n_queries, k=TOP_K, n_clusters=n_clusters, seed=0, device=dev)
    base = torch.as_tensor(ds.base, device=dev)
    queries = torch.as_tensor(ds.queries, device=dev)
    gt = ds.ground_truth[:gt_queries]
    torch.cuda.synchronize()
    data_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()  # the index's peak, not the ground truth's
    n_cap = bucket_capacity(n)

    reset_counts()
    start = read_counts()
    t0 = time.time()
    pq = ProductQuantization.compute(base, m=128 // 8, clusters=256, globally_center=False)
    torch.cuda.synchronize()
    pq_s = time.time() - t0
    t0 = time.time()
    codes = pq.encode(base)
    torch.cuda.synchronize()
    encode_s = time.time() - t0
    build_prov = pq.provider(torch.nn.functional.pad(codes, (0, 0, 0, n_cap - n)), "euclidean")
    phases, prev = {}, [start]

    def on_phase(name: str, secs: float) -> None:  # the outer build's phases, with their launches
        counts = read_counts()
        phases[name] = {"seconds": secs, "launches": {k: counts[k] - prev[0][k] for k in counts}}
        prev[0] = counts

    t0 = time.time()
    graph, _ = GraphIndexBuilder(cfg, on_phase=on_phase).build(base, "euclidean", provider=build_prov)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    build_launches = read_counts()
    recon = pq.reconstruction_error(base[: min(n, 131_072)])

    exact = ExactScoreProvider(vectors=torch.nn.functional.pad(base, (0, 0, 0, n_cap - n)))
    first = pq.provider(codes, "euclidean")
    reset_counts()

    def run(prov, qs, beam):
        return search(graph, prov, qs, top_k=TOP_K, beam_width=beam, rerank_k=beam, reranker=exact)

    recalls, qps = {}, {}
    for oq in OVERQUERY:
        beam = TOP_K * oq
        ids = _check_result(run(first, queries[:gt_queries], beam), gt_queries, f"PQ search at beam {beam}")
        recalls[beam] = recall_at_k(ids, gt, TOP_K)
    ids = _check_result(search(graph, exact, queries[:gt_queries], top_k=TOP_K, beam_width=100), gt_queries,
                        "exact first pass at beam 100")
    exact_first = recall_at_k(ids, gt, TOP_K)
    for beam in timed_beams:
        qps[beam] = _qps(lambda q, b=beam: run(first, q, b), queries)
    t0 = time.time()
    fused = FusedADCScoreProvider(codes=codes, fused_codes=build_fused_codes(graph.base.neighbors, build_prov.codes),
                                  codebooks=pq.codebooks, center=pq.center, sim=first.sim)
    torch.cuda.synchronize()
    fused_s = time.time() - t0
    ids = _check_result(run(fused, queries[:gt_queries], 100), gt_queries, "FUSED_PQ search at beam 100")
    fused_recall = recall_at_k(ids, gt, TOP_K)
    fused_qps = _qps(lambda q: run(fused, q, 100), queries) if timed_beams else None
    serve_launches = read_counts()

    result = {
        "phase": "default_config", "n": n, "dim": 128, "queries": n_queries, "gt_queries": gt_queries,
        "pq": {"m": pq.m, "k": pq.clusters, "centered": pq.center is not None,
               "reconstruction_error": recon, "train_seconds": pq_s, "encode_seconds": encode_s},
        "data_seconds": data_s, "build_seconds": build_s, "build_phases": phases,
        "levels": graph.num_levels, "level_sizes": [int(n)] + [int(x.shape[0]) for x in graph.level_node_ids],
        "average_degree": graph.average_degree(),
        "recall": {str(b): r for b, r in recalls.items()},
        "exact_first_pass_recall_100": exact_first,
        "qps": {str(b): q for b, q in qps.items()},
        "fused_pq": {"recall_100": fused_recall, "qps_100": fused_qps, "table_seconds": fused_s},
        "launches": {"build": build_launches, "serve": serve_launches},
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(result)
    if build_launches["adc_score_kernel"] == 0 or serve_launches["adc_score_kernel"] == 0:
        raise SystemExit(f"K5 was not launched in the build or in serving: {result['launches']}")
    if graph.num_levels > 1 and (build_launches["fused_update_inplace"] == 0):
        raise SystemExit("the hierarchy's sub-builds launched no K2")
    return result


def _ltm_pq_parity(dev: torch.device, tmp: str) -> dict:
    """The PQ stream build at 20k, served through ``search_with_host_rerank``,
    against the JAX package's recall on the same corpus and config."""
    from jvector_tpu_torch.disk import HostVectorStore, build_on_disk_ltm
    from jvector_tpu_torch.disk.host_tier import search_with_host_rerank
    from jvector_tpu_torch.graph import GraphConfig
    from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset

    ds = synthetic_dataset(n=LTM_PQ_N, dim=128, n_queries=512, k=TOP_K, n_clusters=64, seed=0, device=dev)
    reset_counts()
    t0 = time.time()
    graph, prov = build_on_disk_ltm(os.path.join(tmp, "pq.jvtpu"), ds.base, LTM_PQ_N, 128,
                                    config=GraphConfig(max_degree=32, ef_construction=100), compression="pq",
                                    seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    store, queries = HostVectorStore(vectors=ds.base), torch.as_tensor(ds.queries, device=dev)
    recalls = {}
    for beam in JAX_LTM_PQ_RECALL_20K:
        res = search_with_host_rerank(graph, prov, store, queries, top_k=TOP_K, beam_width=beam)
        recalls[beam] = recall_at_k(_check_result(res, 512, f"PQ LTM serve at beam {beam}"), ds.ground_truth, TOP_K)
    return {"n": LTM_PQ_N, "build_seconds": build_s, "average_degree": graph.average_degree(),
            "recall": {str(b): r for b, r in recalls.items()}, "jax_recall": JAX_LTM_PQ_RECALL_20K,
            "port_minus_jax_100": recalls[100] - JAX_LTM_PQ_RECALL_20K[100], "launches": read_counts()}


def phase_ltm_path(n: int, dev: torch.device) -> dict:
    """The larger-than-memory path (see the module docstring); returns the
    result line."""
    import shutil
    import tempfile

    from jvector_tpu_torch.disk import HostGraphIndex, build_on_disk_ltm, load_index, ltm
    from jvector_tpu_torch.graph import GraphConfig
    from jvector_tpu_torch.graph.builder import _shuffled_wave_starts
    from jvector_tpu_torch.util import native
    from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset

    cfg = GraphConfig(max_degree=32, ef_construction=100, add_hierarchy=True)
    t0 = time.time()
    ds = synthetic_dataset(n=n, dim=128, n_queries=GT_QUERIES, k=TOP_K, n_clusters=max(64, n // 500), seed=0,
                           device=dev)
    base = np.ascontiguousarray(ds.base, np.float32)  # host only: the build streams it
    data_s = time.time() - t0
    loads = [0]

    def loader(a: int, b: int) -> np.ndarray:
        loads[0] += 1
        return base[a:b]

    tmp = tempfile.mkdtemp(prefix="jvtpu_ltm_")
    try:
        path = os.path.join(tmp, "ltm.jvtpu")
        free_gb = shutil.disk_usage(tmp).free / 2**30
        ltm._FUSED_BUILD_BUDGET = 0  # the base layer takes the packed (K3) regime
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        phases = {}
        reset_counts()
        t0 = time.time()
        graph, provider = build_on_disk_ltm(path, loader, n, 128, config=cfg, compression="sq4", seed=0, device=dev,
                                            on_phase=lambda name, secs: phases.__setitem__(name, secs))
        torch.cuda.synchronize()
        build_s = time.time() - t0
        build_launches = read_counts()
        build_peak = torch.cuda.max_memory_allocated() / 2**30
        regime = next(k.split("/", 1)[1] for k in phases if k.startswith("waves/"))
        n_waves = len(_shuffled_wave_starts(n, cfg.wave_size))
        file_gb = os.path.getsize(path) / 2**30
        # the returned graph, kept on the host for the round trip; the card is
        # freed so the serve's peak is its own
        want = [(layer.neighbors.cpu(), layer.counts.cpu()) for layer in graph.layers]
        want_ids = [x.cpu() for x in graph.level_node_ids]
        want_entry, levels = int(graph.entry_node), graph.num_levels
        del graph, provider
        torch.cuda.empty_cache()

        reset_counts()
        hg = HostGraphIndex.load(path, device=dev)
        kw = dict(top_k=TOP_K, beam_width=HOST_BEAM, expand=HOST_EXPAND)
        hg.search(ds.queries[:64], **kw).ids.cpu()  # warm-up: uploads the upper levels
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = hg.search(ds.queries, **kw)
        ids = _check_result(res, GT_QUERIES, "host-served search")
        serve_s = time.time() - t0
        serve_peak = torch.cuda.max_memory_allocated()
        host_recall = recall_at_k(ids, ds.ground_truth, TOP_K)
        serve_launches = read_counts()
        host_bytes = sum(a.nbytes for a in (hg.neighbors, hg.fused_packed, hg.fused_w2, hg.codes_packed,
                                            hg.node_const, hg.rerank_store.vectors))
        hbm_mb = hg.hbm_bytes(GT_QUERIES, HOST_BEAM, HOST_EXPAND) / 2**20

        back = load_index(path).graph_to_device(dev)
        round_trip = (
            back.num_levels == levels and int(back.entry_node) == want_entry
            and all(torch.equal(b.neighbors.cpu(), w[0]) and torch.equal(b.counts.cpu(), w[1])
                    for b, w in zip(back.layers, want))
            and all(torch.equal(b.cpu(), w) for b, w in zip(back.level_node_ids, want_ids))
        )
        del back, hg
        torch.cuda.empty_cache()

        pq = _ltm_pq_parity(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    result = {
        "phase": "ltm_path", "n": n, "dim": 128, "regime": regime, "n_waves": n_waves, "loader_calls": loads[0],
        "data_seconds": data_s, "build_seconds": build_s, "build_phases": phases, "levels": levels,
        "file_gb": file_gb, "tmp_free_gb": free_gb, "host_io": native.backend(),
        "launches": {"build": build_launches, "serve": serve_launches, "pq_20k": pq.pop("launches")},
        "build_peak_memory_gb": build_peak,
        "serve": {"queries": GT_QUERIES, "beam_width": HOST_BEAM, "expand": HOST_EXPAND, "recall": host_recall,
                  "qps": GT_QUERIES / serve_s, "seconds": serve_s,
                  "peak_memory_mb": serve_peak / 2**20, "resident_before_mb": resident / 2**20,
                  "hbm_bytes_mb": hbm_mb, "host_array_gb": host_bytes / 2**30},
        "round_trip_exact": round_trip, "pq_ltm": pq,
    }
    emit(result)
    if regime != "packed":
        raise SystemExit(f"the LTM build took the {regime} regime, not packed")
    if build_launches["packed_adj_only_update_inplace"] != n_waves:
        raise SystemExit(f"K3 launched {build_launches['packed_adj_only_update_inplace']} times over {n_waves} waves")
    if host_recall < HOST_RECALL_FLOOR:
        raise SystemExit(f"host-served recall@10 {host_recall} < {HOST_RECALL_FLOOR}")
    if not round_trip:
        raise SystemExit("load_index(...).graph_to_device differs from the returned graph")
    if abs(pq["port_minus_jax_100"]) > PARITY_SLACK:
        raise SystemExit(f"PQ LTM recall at beam 100 is {pq['port_minus_jax_100']:+} from the JAX figure")
    if result["launches"]["pq_20k"]["adc_score_kernel"] == 0:
        raise SystemExit("the PQ stream build launched no K5")
    return result


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=1_000_000,
                   help="corpus size of the LTM path; the earlier paths run at min(n, 200,000)")
    args = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    n_earlier = min(args.n, EARLIER_N)

    phase_env()
    phase_build()
    kernels = phase_kernel_check()
    ltm = phase_ltm_path(args.n, dev)
    sq4 = phase_sq4_path(n_earlier, dev)
    small = phase_default_config(20_000, dev, n_queries=512, n_clusters=64, gt_queries=512, timed_beams=())
    off = {b: small["recall"][str(b)] - JAX_RECALL_20K[b] for b in JAX_RECALL_20K}
    emit({"phase": "default_config_parity", "n": 20_000, "jax_recall": JAX_RECALL_20K,
          "port_minus_jax": off, "slack": PARITY_SLACK})
    if any(abs(d) > PARITY_SLACK for d in off.values()):
        raise SystemExit(f"20k default-config recall differs from the JAX figures by more than {PARITY_SLACK}: {off}")
    big = phase_default_config(n_earlier, dev, n_queries=N_QUERIES, n_clusters=max(64, n_earlier // 500),
                               gt_queries=GT_QUERIES, timed_beams=(20, 100))
    if n_earlier == EARLIER_N and big["recall"]["100"] < SANITY_FLOOR_200K:
        raise SystemExit(f"recall@10 at beam 100 is {big['recall']['100']} < {SANITY_FLOOR_200K}")

    main_path = {"packed_adj_update_inplace": ("sq4_path",), "fused_update_inplace": ("sq4_path",),
                 "packed_adj_only_update_inplace": ("ltm_build",),
                 "adc_score_kernel": ("default_config_build", "default_config_serve")}
    for k in kernels:
        name = k["name"]
        by_path = {"sq4_path": sq4["launches"][name],
                   "default_config_build": big["launches"]["build"][name],
                   "default_config_serve": big["launches"]["serve"][name],
                   "ltm_build": ltm["launches"]["build"][name],
                   "ltm_serve": ltm["launches"]["serve"][name],
                   "ltm_pq_20k": ltm["launches"]["pq_20k"][name]}
        k["launches"] = sum(by_path[path] for path in main_path[name])
        k["launches_by_path"] = by_path
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(torch.cuda.current_device()),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
