"""Drive the PyTorch/CUDA port's paths once on one GPU.

    python3 chip_smoke.py              # mips-96d at 1M, the other paths at 200k
    python3 chip_smoke.py --n 50000    # a shorter rehearsal: every path at 50k

Phases, each printing one JSON line:

1. environment: torch / CUDA / nvcc versions and the card's name and power
   limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them; exits
   non-zero without a CUDA device;
2. kernel build: compiles ``jvector_tpu_torch/csrc/*.cu``, one nvcc per
   source, all started together;
3. kernel check: K1 (packed adjacency), K3 (packed adjacency without the
   w2 table) and K2 (fused SQ4 code table) against their plain PyTorch
   twins at the 1M build shapes (bit-exact, ``torch.equal``); K4a (row
   scatter into the ``[1,048,576, 24, 128]`` uint8 fused table of the 1M
   mips-96d build, B = 17,408 rows with dropped and duplicate-identical
   rows), K4b (the same scatter on that table viewed 2-D, and on a
   ``[1,048,576, 64]`` float32 table) and K7 (slot scatter on the float32
   table, and 48-byte slots on the 2-D uint8 view) against their twins
   (bit-exact); and K5 (PQ ADC) against its twin at the build, serve,
   centroid-scan and an unaligned shape (``torch.allclose(rtol=1e-5,
   atol=1e-4)``: only the order of the float32 sum differs), and K6 (LUT16
   ADC) against its twin at the flagship and 1M mips-96d serve shapes, the
   micro's, the shared-table cosine norm and an unaligned shape (the same
   tolerance); each with the median time of 20 runs from CUDA events,
   beside its bound (bytes over 3.35 TB/s) and the PyTorch call that
   computes the same function, where one does (K4a / K4b: ``index_copy_``,
   K7: ``index_put_``, K5: gather + sum, K6: a gather per nibble + sum);
4. robustness (``bench.py``'s robustness corpora through
   ``jvector_tpu_torch.bench.headline``): **mips-96d at ``--n``** (the main
   path, at bench.py's size): ``synthetic_dataset(n, dim=96,
   sim="dot_product", n_clusters=max(64, n // 500), seed=4)``,
   ``build_graph(..., "dot_product", GraphConfig(max_degree=32,
   ef_construction=100))``, whose SQ4 build takes the fused loop's
   whole-row fallback on ``[N, 24, 128]`` tables (K4a once per wave), SQ4
   ``provider_for_graph`` and bench's ``measure`` at floor 0.95 over 4096
   queries (recall over 1024); then **clustered-adversarial at
   ``min(--n, 200,000)``** the same way, held at n = 200,000 to the JAX
   package's recall@10 at beams 100 and 200
   (``experiments/torch_robustness_cpu.py``).
   Before the mips-96d index is freed, a LUT16 serve over its graph (PQ at
   m = 48, K = 16, ``sim="dot_product"``, exact rerank at ``rerank_k =
   beam``): recall@10 at beams 100, 200 and 400 and QPS at beam 200,
   recorded without a floor (the reference's own LUT16 recall falls with
   n on this corpus, ``experiments/torch_lut16_cpu.py``).
   Fails if no beam <= 200 reaches recall@10 0.95 on mips-96d, if K4a's
   launches over that build differ from the number of waves or K1 or K2
   launched there, if K6 did not launch in the LUT16 serve, or if the
   adversarial recall is more than 0.03 from the JAX figure;
5. LTM path (``min(--n, 200,000)``): the larger-than-memory
   stream build ``build_on_disk_ltm(compression="sq4",
   GraphConfig(max_degree=32, ef_construction=100, add_hierarchy=True))``
   of ``synthetic_dataset(n, dim=128, seed=0, n_clusters=n // 500)`` from
   a chunk loader over the host array (the corpus is never uploaded whole)
   into a temporary directory (deleted at the end),
   with ``ltm._FUSED_BUILD_BUDGET = 0`` so the base layer takes the packed
   regime (K3 once per wave) and ``ltm._FUSED_SERVE_BUDGET = 0`` so the
   save takes the larger-than-memory branch (L0 pulled to the host, the
   fused layout streamed into the file from numpy, a provider without
   fused tables), as a corpus beyond those budgets does (both restored
   afterwards); then ``HostGraphIndex.load`` serves 1024
   queries with exact ground truth at beam 64, expand 4, with the default
   host rerank; ``load_index(path).graph_to_device`` must give back the
   returned graph exactly; and a PQ stream build at n = 20,000 served
   through ``search_with_host_rerank`` is held to the JAX package's recall
   at beam 100 (``experiments/torch_ltm_pq_cpu.py``).  Fails if the regime
   is not packed or the save not the host-streamed one, if K3's launches differ from the number of waves, if
   host-served recall@10 is below 0.90, if the round trip differs, or if
   the 20k PQ recall is more than 0.03 from the JAX figure;
6. SQ4 path (the flagship path, at ``min(--n, 200,000)``):
   ``build_graph`` at ``GraphConfig(max_degree=32, ef_construction=100)``,
   SQ4 compute/encode/provider_for_graph, exact ground truth for 1024
   queries, two-pass SQ4 + exact-rerank search in 4096-query waves at beam
   100 and at the smallest beam of bench.py's list that clears recall
   0.955; then the **LUT16 serve** over the same graph
   (``experiments/search_sweep_1m.py``'s ``lut16_64``: PQ at m = 64, K = 16,
   codes packed two a byte, ``build_fused_codes_lut16``, LUT16 first pass
   through K6 + exact rerank at ``rerank_k = beam``) at beams 40, 100 and
   200, QPS at beam 100, with the PQ and fused-table seconds and bytes.
   Fails if recall@10 at beam 100 is below 0.95 (SQ4 or LUT16), if K1's or
   K2's launch count over the build differs from the number of build
   waves, or if K6 did not launch in the LUT16 serve;
7. default configuration (upstream JVector's ``yaml-configs/default.yml``:
   outDegree 32, efConstruction 100, overflow 1.2, hierarchy, PQ
   construction and search with M = d/8 = 16, K = 256, no centering, FP32
   rerank, overquery 1/2/5/10), first at n = 20,000 (512 queries) against
   the JAX package's recall figures for that corpus, then at
   ``min(--n, 200,000)``: PQ compute +
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
8. LUT16 parity: the port builds the headline 128-d corpus at n = 20,000
   (``GraphConfig(max_degree=32, ef_construction=100)``) and serves it as
   in phase 6 at beams 40, 100 and 200, over 1024 queries; fails if
   recall@10 at beam 100 is more than 0.03 from the JAX package's
   (``experiments/torch_lut16_cpu.py``); beams 40 and 200 are printed
   beside the JAX figures, unchecked (at beam 40 the port's own k-means
   draws move recall more than the slack);
9. micro: ``jvector_tpu_torch.bench.micro.run_micro()`` at its defaults
   (n = 100,000, d = 128, 1024 queries, waves of 256), its eight rows and
   the launches over them; fails if K5 or K6 did not launch.

Phases run in this order.  Kernel
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
EARLIER_N = 200_000  # every path but mips-96d, cut from 1M for the script's time
ROBUST_QUERIES = 4096  # bench.py's robustness queries: min(--queries, 4096), one wave
# recall@10 of the JAX package at beams 100 and 200 on bench.py's
# clustered_adversarial(200_000, 128, 4096) (seed 7): build_graph at
# GraphConfig(max_degree=32, ef_construction=100) (SQ4 build scoring), SQ4
# first pass + exact rerank at rerank_k = beam, repack cut 1.6 x beam, over
# the first 1024 queries (experiments/torch_robustness_cpu.py)
ADVERSARIAL_N = 200_000
JAX_ADVERSARIAL_RECALL_200K = {100: 0.9568359375, 200: 0.9861328125}
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
# LUT16 (4-bit PQ, m = d/2, K = 16) first pass with exact rerank at
# rerank_k = beam: the JAX package's recall@10 on synthetic_dataset(n=20_000,
# dim=128, n_queries=1024, k=10, n_clusters=64, seed=0), build_graph at
# GraphConfig(max_degree=32, ef_construction=100), over the 1024 queries
# (experiments/torch_lut16_cpu.py); held at beam 100 within PARITY_SLACK
LUT16_N = 20_000
JAX_LUT16_RECALL_20K = {40: 0.91982421875, 100: 0.99560546875, 200: 0.99990234375}
LUT16_BEAMS, LUT16_QPS_BEAM = (40, 100, 200), 100  # the flagship corpus's serve
LUT16_MIPS_BEAMS, LUT16_MIPS_QPS_BEAM = (100, 200, 400), 200  # mips-96d: recorded, no floor


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
    from jvector_tpu_torch.ops.kernels import _build, adc, adc16, packed_adj, scatter_rows

    t0 = time.time()
    sources = sorted(f for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        list(pool.map(_build.build, sources))
    for load in (packed_adj._lib, scatter_rows._lib, scatter_rows._scatter_lib, adc._lib, adc16._lib):
        load()
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


def _scatter_rows_case(rng: np.random.Generator, dev, row_shape: tuple, dtype, n_cap: int = 1_048_576):
    """K4a / K4b at the 1M mips-96d build shapes: a ``[1,048,576, *row_shape]``
    table and one wave's B = W + W*M + W = 17,408 row images (W = 512,
    M = 32): unique rows, 40 dropped (-1 and N), and the last 16 repeating
    earlier rows with identical images (duplicate enforce rows)."""
    b = 512 + 512 * 32 + 512
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))

    def rnd(*shape):
        if dtype == torch.float32:
            return torch.randn(shape, generator=gen, device=dev)
        return torch.randint(0, 256, shape, generator=gen, dtype=dtype, device=dev)

    idx = rng.choice(n_cap, b, replace=False).astype(np.int32)
    idx[rng.choice(b - 32, 40, replace=False) + 16] = np.where(np.arange(40) % 2, -1, n_cap)
    idx[-16:] = idx[:16]
    payload = rnd(b, *row_shape)
    payload[-16:] = payload[:16]
    return rnd(n_cap, *row_shape), (torch.as_tensor(idx, device=dev), payload)


def _scatter_slots_case(rng: np.random.Generator, dev, table: torch.Tensor, kp: int):
    """K7 at the 1M build's backlink shape: W*M = 16,384 slot writes in runs
    of distinct slots per row (several per row), 5% dropped rows; slot s of
    a row sits at element offset ``s * kp``."""
    n_cap, gen = table.shape[0], torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    rows, slots = [], []
    for r in rng.choice(n_cap, 6000, replace=False):
        k = int(rng.integers(1, 7))
        rows += [r] * k
        slots += list(rng.permutation(table.shape[1] // kp)[:k])
    p = 512 * 32
    rows, slots = np.array(rows[:p], np.int32), np.array(slots[:p], np.int32)
    rows[rng.random(p) < 0.05] = -1
    if table.dtype == torch.float32:
        payload = torch.randn((p, kp), generator=gen, device=dev)
    else:
        payload = torch.randint(0, 256, (p, kp), generator=gen, dtype=table.dtype, device=dev)
    return torch.as_tensor(rows, device=dev), torch.as_tensor(slots * kp, device=dev), payload


def _scatter_landed(table: torch.Tensor, args: tuple) -> int:
    """Rows (K4a / K4b: ``(idx, payload)``) or slots (K7: ``(idx, off,
    payload)``, distinct (row, offset) pairs) that land in ``table``."""
    idx, payload = args[0], args[-1]
    ok = (idx >= 0) & (idx < table.shape[0])
    if len(args) == 3:
        ok &= (args[1] >= 0) & (args[1] + payload.shape[1] <= table[0].numel())
        return int(ok.sum())
    return int(torch.unique(idx[ok]).numel())


def _scatter_bytes(table: torch.Tensor, args: tuple) -> int:
    """A scatter's least traffic: the index streams read once, and every row
    or slot that lands read from the payload and written once."""
    payload = args[-1]
    row_bytes = payload[0].numel() * payload.element_size()
    return sum(x.numel() * x.element_size() for x in args[:-1]) + 2 * _scatter_landed(table, args) * row_bytes


def _scatter_check(what: str, kernel, twin, table: torch.Tensor, args: tuple, library) -> dict:
    """One scatter kernel against its twin on copies of ``table``: exactness,
    times (kernel, twin, the one PyTorch call of ``library(table)``) and
    the bound from :func:`_scatter_bytes`."""
    kt = table.clone()
    kernel(kt, *args)
    rt = table.clone()
    twin(rt, *args)
    torch.cuda.synchronize()
    exact = torch.equal(kt, rt)
    diff = kt != rt
    err = 0.0 if exact else float((kt[diff].double() - rt[diff].double()).abs().max())
    del diff
    flat = kt.view(kt.shape[0], -1)
    changed = int((flat != table.view(table.shape[0], -1)).any(dim=1).sum())
    n_bytes, landed = _scatter_bytes(table, args), _scatter_landed(table, args)
    row_bytes = args[-1][0].numel() * args[-1].element_size()
    ms = median_ms(lambda: kernel(kt, *args))
    plain_ms = median_ms(lambda: twin(rt, *args))
    library_ms = median_ms(lambda: library(rt))
    del kt, rt
    return {"kernel": what, "table": list(table.shape), "dtype": str(table.dtype).replace("torch.", ""),
            "B": int(args[0].shape[0]), "payload_row_bytes": row_bytes, "landed": landed, "bit_exact": exact,
            "max_abs_err": err, "rows_changed": changed, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bytes": n_bytes, "bound_ms": bound_ms(n_bytes)}


def index_copy(table: torch.Tensor, idx: torch.Tensor, payload: torch.Tensor):
    """K4a's / K4b's library yardstick: ``index_copy_`` of the in-range rows,
    as a function of the table."""
    ok = (idx >= 0) & (idx < table.shape[0])
    rows, src = idx[ok].long(), payload[ok]
    return lambda t: t.index_copy_(0, rows, src)


def index_put(table: torch.Tensor, idx: torch.Tensor, off: torch.Tensor, payload: torch.Tensor):
    """K7's library yardstick: ``index_put_`` of the slots that land, as a
    function of the table."""
    ok = (idx >= 0) & (idx < table.shape[0]) & (off >= 0) & (off + payload.shape[1] <= table.shape[1])
    cols = off[ok].long()[:, None] + torch.arange(payload.shape[1], device=table.device)[None, :]
    rows, src = idx[ok].long()[:, None].expand_as(cols), payload[ok]
    return lambda t: t.index_put_((rows, cols), src)


def phase_scatter_check(rng: np.random.Generator) -> list[dict]:
    """K4a, K4b and K7 against their twins at the mips-96d build shapes."""
    from jvector_tpu_torch.ops.kernels.scatter_rows import (
        scatter_rows3_inplace,
        scatter_rows_inplace,
        scatter_rows_ref,
        scatter_slots_inplace,
        scatter_slots_ref,
    )

    dev = torch.device("cuda")

    table, args = _scatter_rows_case(rng, dev, (24, 128), torch.uint8)
    k4a = _scatter_check("K4a scatter_rows3_inplace", scatter_rows3_inplace, scatter_rows_ref, table, args,
                         index_copy(table, *args))
    flat_args = (args[0], args[1].view(args[1].shape[0], -1))
    flat = table.view(table.shape[0], -1)
    k4b_u8 = _scatter_check("K4b scatter_rows_inplace", scatter_rows_inplace, scatter_rows_ref, flat, flat_args,
                            index_copy(flat, *flat_args))
    del args, flat_args
    s_args = _scatter_slots_case(rng, dev, flat, 48)
    k7_u8 = _scatter_check("K7 scatter_slots_inplace", scatter_slots_inplace, scatter_slots_ref, flat, s_args,
                           index_put(flat, *s_args))
    del table, flat, s_args
    torch.cuda.empty_cache()
    w2, args = _scatter_rows_case(rng, dev, (64,), torch.float32)
    k4b_f32 = _scatter_check("K4b scatter_rows_inplace", scatter_rows_inplace, scatter_rows_ref, w2, args,
                             index_copy(w2, *args))
    del args
    s_args = _scatter_slots_case(rng, dev, w2, 1)
    k7_f32 = _scatter_check("K7 scatter_slots_inplace", scatter_slots_inplace, scatter_slots_ref, w2, s_args,
                            index_put(w2, *s_args))
    del w2, s_args
    torch.cuda.empty_cache()
    cases = {"K4a": [k4a], "K4b": [k4b_u8, k4b_f32], "K7": [k7_f32, k7_u8]}
    for name, rows in cases.items():
        emit({"phase": "kernel_check", "kernel": name, "cases": rows})
        bad = [r for r in rows if not r["bit_exact"] or r["rows_changed"] == 0]
        if bad:
            raise SystemExit(f"{name} disagrees with its twin (or wrote nothing): {bad}")
    return [{"name": name, "route": "cuda", "source": "jvector_tpu_torch/csrc/scatter_rows.cu",
             "replaces": f"jvector_tpu/ops/pallas/scatter_rows.py:{line}",
             "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
             "bound_ms": row["bound_ms"], "bound_by": "bytes", "library_ms": row["library_ms"]}
            for name, line, row in (("scatter_rows3_inplace", 82, k4a), ("scatter_rows_inplace", 54, k4b_u8),
                                    ("scatter_slots_inplace", 189, k7_f32))]


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
        row["library_ms"] = median_ms(lambda: _k5_library(luts, codes))
    return row


def _k5_library(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """The same function in PyTorch calls: one gather, summed over M."""
    return torch.gather(luts, 2, codes.transpose(1, 2).long()).sum(1)


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


# K6 shapes (Q, MP, C, shared table): the flagship 128-d serve (MP = 32, one
# expansion of R = 64 slots per 4096-query wave), the 1M mips-96d serve
# (MP = 24), the micro's lut16_adc_score (256 queries x 64 candidates), the
# cosine norm (one table of squared centroid norms, query stride 0) and an
# unaligned shape
K6_SHAPES = {
    "serve_200k": (4096, 32, 64, False),
    "serve_mips_1m": (4096, 24, 64, False),
    "micro": (256, 32, 64, False),
    "cosine_norm_shared": (4096, 32, 64, True),
    "unaligned": (12, 13, 70, False),
}


def _k6_inputs(gen: torch.Generator, q: int, mp: int, c: int, shared: bool):
    dev = torch.device("cuda")
    luts = torch.rand((1 if shared else q, mp, 32), generator=gen, device=dev) * 50.0
    codes = torch.randint(0, 256, (q, mp, c), generator=gen, device=dev, dtype=torch.uint8)
    return luts.expand(q, -1, -1), codes


def _k6_bytes(luts: torch.Tensor, codes: torch.Tensor) -> int:
    """K6's least traffic: each distinct table read once (one for a shared
    table), the codes read once, the scores written once."""
    tables = 1 if luts.stride(0) == 0 else luts.shape[0]
    return tables * luts[0].numel() * 4 + codes.numel() + codes.shape[0] * codes.shape[2] * 4


def _k6_library(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """The same function in PyTorch calls: a gather per nibble, summed over MP."""
    return (torch.gather(luts[..., :16], 2, (codes & 15).long())
            + torch.gather(luts[..., 16:], 2, (codes >> 4).long())).sum(1)


def _k6_check(gen, q, mp, c, shared, timed: bool) -> dict:
    from jvector_tpu_torch.ops.adc16 import adc16_ref
    from jvector_tpu_torch.ops.kernels.adc16 import adc16_score_kernel

    luts, codes = _k6_inputs(gen, q, mp, c, shared)
    got = adc16_score_kernel(luts, codes)
    want = adc16_ref(luts, codes)
    torch.cuda.synchronize()
    row = {"shape": {"Q": q, "MP": mp, "C": c, "shared_table": shared},
           "allclose": bool(torch.allclose(got, want, rtol=1e-5, atol=1e-4)),
           "max_abs_err": float((got - want).abs().max()), "bytes": _k6_bytes(luts, codes)}
    row["bound_ms"] = bound_ms(row["bytes"])
    if timed:
        row["ms"] = median_ms(lambda: adc16_score_kernel(luts, codes))
        row["plain_ms"] = median_ms(lambda: adc16_ref(luts, codes))
        row["library_ms"] = median_ms(lambda: _k6_library(luts, codes))
    return row


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

    rows = {name: _k6_check(gen, *shape, timed=name != "unaligned") for name, shape in K6_SHAPES.items()}
    emit({"phase": "kernel_check", "kernel": "K6 adc16_score_kernel", "shapes": rows})
    bad = [name for name, r in rows.items() if not r["allclose"]]
    if bad:
        raise SystemExit(f"K6 disagrees with its twin at {bad}")
    serve = rows["serve_200k"]
    out.append({"name": "adc16_score_kernel", "route": "cuda",
                "source": "jvector_tpu_torch/csrc/adc16.cu",
                "replaces": "jvector_tpu/ops/pallas/adc16_kernel.py:109",
                "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
                "ms": serve["ms"], "plain_ms": serve["plain_ms"], "bound_ms": serve["bound_ms"],
                "bound_by": "bytes", "library_ms": serve["library_ms"]})
    torch.cuda.empty_cache()
    return out


def _counters() -> dict:
    from jvector_tpu_torch.ops.kernels import (
        adc16_score_kernel,
        adc_score_kernel,
        fused_update_inplace,
        packed_adj_only_update_inplace,
        packed_adj_update_inplace,
        scatter_rows3_inplace,
        scatter_rows_inplace,
        scatter_slots_inplace,
    )

    return {"packed_adj_update_inplace": packed_adj_update_inplace,
            "packed_adj_only_update_inplace": packed_adj_only_update_inplace,
            "fused_update_inplace": fused_update_inplace,
            "scatter_rows3_inplace": scatter_rows3_inplace,
            "scatter_rows_inplace": scatter_rows_inplace,
            "scatter_slots_inplace": scatter_slots_inplace,
            "adc_score_kernel": adc_score_kernel,
            "adc16_score_kernel": adc16_score_kernel}


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


def _lut16_serve(graph, exact, base: torch.Tensor, queries: torch.Tensor, gt: np.ndarray, sim: str, beams: tuple,
                 qps_beam: int | None) -> dict:
    """A LUT16 (4-bit PQ, m = d/2, K = 16) first pass with exact rerank
    (``rerank_k = beam``) over a built graph, as
    ``experiments/search_sweep_1m.py``'s ``lut16_<m>`` mode serves it: PQ
    train, encode and fused-table seconds and bytes, recall@10 over the
    first ``len(gt)`` queries at ``beams``, QPS at ``qps_beam`` over >=
    :data:`MIN_TIMED_QUERIES` queries, and the launches, counted from 0."""
    from jvector_tpu_torch.graph import LUT16ScoreProvider, build_fused_codes_lut16, search
    from jvector_tpu_torch.ops.adc16 import pack_nibbles
    from jvector_tpu_torch.quantization import ProductQuantization
    from jvector_tpu_torch.util.datasets import recall_at_k

    n, d = base.shape
    reset_counts()
    t0 = time.time()
    pq = ProductQuantization.compute(base, m=d // 2, clusters=16)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    t0 = time.time()
    packed = torch.nn.functional.pad(pack_nibbles(pq.encode(base)), (0, 0, 0, graph.capacity - n))
    torch.cuda.synchronize()
    encode_s = time.time() - t0
    t0 = time.time()
    fused = build_fused_codes_lut16(graph.base.neighbors, packed)
    torch.cuda.synchronize()
    fused_s = time.time() - t0
    prov = LUT16ScoreProvider(codes_packed=packed, fused_packed=fused, codebooks=pq.codebooks, center=pq.center,
                              sim=sim)

    def run(qs, beam):
        return search(graph, prov, qs, top_k=TOP_K, beam_width=beam, rerank_k=beam, reranker=exact)

    n_gt = gt.shape[0]
    recalls = {}
    for beam in beams:
        ids = _check_result(run(queries[:n_gt], beam), n_gt, f"LUT16 search at beam {beam}")
        recalls[beam] = recall_at_k(ids, gt, TOP_K)
    row = {"m": pq.m, "k": pq.clusters, "mp": packed.shape[1], "fused_table": list(fused.shape),
           "pq_train_seconds": train_s, "encode_seconds": encode_s, "fused_table_seconds": fused_s,
           "codes_bytes": packed.numel(), "fused_table_bytes": fused.numel(),
           "recall": {str(b): r for b, r in recalls.items()}}
    if qps_beam is not None:
        row["qps_beam"], row["qps"] = qps_beam, _qps(lambda q: run(q, qps_beam), queries)
    row["launches"] = read_counts()
    del prov, fused, packed
    torch.cuda.empty_cache()
    return row


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

    # the LUT16 serve over the same graph (experiments/search_sweep_1m.py's lut16_64)
    del sq4, codes
    torch.cuda.empty_cache()
    lut16 = {"phase": "lut16_serve", "n": n, "dim": 128, "sim": "euclidean",
             **_lut16_serve(graph, exact, base, queries, gt, "euclidean", LUT16_BEAMS, LUT16_QPS_BEAM)}
    emit(lut16)
    if lut16["recall"]["100"] < RECALL_FLOOR:
        raise SystemExit(f"LUT16 recall@10 at beam 100 is {lut16['recall']['100']} < {RECALL_FLOOR}")
    if lut16["launches"]["adc16_score_kernel"] == 0:
        raise SystemExit("the LUT16 serve launched no K6")
    result["lut16"] = lut16
    return result


def phase_lut16_parity(dev: torch.device) -> dict:
    """The LUT16 serve on a graph the port builds at n = 20,000 on the
    headline 128-d corpus, held to the JAX package's recall at beam 100."""
    from jvector_tpu_torch.graph import GraphConfig, build_graph
    from jvector_tpu_torch.util.datasets import synthetic_dataset

    ds = synthetic_dataset(n=LUT16_N, dim=128, n_queries=GT_QUERIES, k=TOP_K, n_clusters=64, seed=0, device=dev)
    base = torch.as_tensor(ds.base, device=dev)
    t0 = time.time()
    graph, exact = build_graph(base, "euclidean", GraphConfig(max_degree=32, ef_construction=100))
    torch.cuda.synchronize()
    build_s = time.time() - t0
    row = _lut16_serve(graph, exact, base, torch.as_tensor(ds.queries, device=dev), ds.ground_truth, "euclidean",
                       tuple(JAX_LUT16_RECALL_20K), None)
    off = {b: row["recall"][str(b)] - r for b, r in JAX_LUT16_RECALL_20K.items()}
    result = {"phase": "lut16_parity", "n": LUT16_N, "build_seconds": build_s,
              "average_degree": graph.average_degree(), **row, "jax_recall": JAX_LUT16_RECALL_20K,
              "port_minus_jax": off, "held": {"beam": 100, "slack": PARITY_SLACK}}
    emit(result)
    if abs(off[100]) > PARITY_SLACK:
        raise SystemExit(f"20k LUT16 recall at beam 100 is {off[100]:+} from the JAX figure")
    return result


def phase_micro(dev: torch.device) -> dict:
    """``jvector_tpu_torch.bench.micro.run_micro`` at its defaults, with the
    launches over its rows."""
    from jvector_tpu_torch.bench.micro import run_micro

    reset_counts()
    t0 = time.time()
    rows = run_micro(device=dev)
    result = {"phase": "micro", "seconds": time.time() - t0, "rows": rows, "launches": read_counts()}
    emit(result)
    for name in ("adc_score_kernel", "adc16_score_kernel"):
        if result["launches"][name] == 0:
            raise SystemExit(f"the micro launched no {name}")
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


def _robustness_corpus(name: str, base: np.ndarray, queries: np.ndarray, sim: str, dev: torch.device,
                       n_waves: int, lut16: bool = False) -> dict:
    """bench.py's robustness row for one corpus through the bench's own
    ``robustness_row`` (one :data:`ROBUST_QUERIES`-query wave), with the
    build's and the serve's launches counted from 0, the build's peak
    memory, and recall@10 at beams 100 and 200; with ``lut16``, also a
    LUT16 serve over the same graph before the index is freed."""
    from jvector_tpu_torch.bench import headline
    from jvector_tpu_torch.util.datasets import recall_at_k

    row = {"corpus": name, "n": base.shape[0], "dim": base.shape[1], "sim": sim, "n_waves": n_waves}
    index = {}

    def after_build(built):
        graph, exact, sq4, upload_s, _, encode_s = built
        row.update(fused_table=list(sq4.fused_packed.shape), upload_seconds=upload_s, sq4_encode_seconds=encode_s,
                   build_peak_memory_gb=torch.cuda.max_memory_allocated() / 2**30,
                   average_degree=graph.average_degree(), launches={"build": read_counts()})
        if lut16:
            index.update(graph=graph, exact=exact)
        reset_counts()

    def after_measure(run, q, gt):
        row["launches"]["serve"] = read_counts()
        for b in (100, 200):
            ids = _check_result(run(q[:GT_QUERIES], b), GT_QUERIES, f"{name} at beam {b}")
            row[f"recall_{b}"] = recall_at_k(ids, gt, TOP_K)
        if lut16:
            graph, exact = index.pop("graph"), index.pop("exact")
            row["lut16"] = _lut16_serve(graph, exact, exact.vectors[: base.shape[0]], q, gt, sim, LUT16_MIPS_BEAMS,
                                        LUT16_MIPS_QPS_BEAM)
            row["launches"]["lut16"] = row["lut16"].pop("launches")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    (qps, qps_serial, recall, beam, p999), build_s = headline.robustness_row(
        base, queries, sim, dev, wave=ROBUST_QUERIES, timed_queries=ROBUST_QUERIES, top_k=TOP_K,
        gt_queries=GT_QUERIES, after_build=after_build, after_measure=after_measure)
    torch.cuda.empty_cache()
    row.update(build_seconds=build_s, beam_width=beam, recall=recall, qps=qps, qps_serial=qps_serial,
               latency_p999_ms=p999)
    return row


def phase_robustness(n: int, n_adv: int, dev: torch.device) -> dict:
    """bench.py's robustness corpora (see the module docstring); returns the
    result line."""
    from jvector_tpu_torch.bench import headline
    from jvector_tpu_torch.graph.builder import _shuffled_wave_starts

    cfg = headline.CONFIG
    t0 = time.time()
    base, queries = headline.mips_96d(n, ROBUST_QUERIES, TOP_K, dev)
    data_s = time.time() - t0
    mips = _robustness_corpus("mips-96d", base, queries, "dot_product", dev,
                              len(_shuffled_wave_starts(n, cfg.wave_size)), lut16=True)
    mips["data_seconds"] = data_s
    del base, queries
    base, queries = headline.clustered_adversarial(n_adv, 128, ROBUST_QUERIES)
    adv = _robustness_corpus("clustered-adversarial", base, queries, "euclidean", dev,
                             len(_shuffled_wave_starts(n_adv, cfg.wave_size)))
    del base, queries
    if n_adv == ADVERSARIAL_N:
        adv["jax_recall"] = {str(b): r for b, r in JAX_ADVERSARIAL_RECALL_200K.items()}
        adv["port_minus_jax"] = {str(b): adv[f"recall_{b}"] - r for b, r in JAX_ADVERSARIAL_RECALL_200K.items()}
    result = {"phase": "robustness", "mips_96d": mips, "clustered_adversarial": adv}
    emit(result)
    build = mips["launches"]["build"]
    if mips["recall"] < RECALL_FLOOR:
        raise SystemExit(f"mips-96d: no beam <= {headline.BEAMS[-1]} reaches recall@10 {RECALL_FLOOR} "
                         f"(beam {mips['beam_width']}: {mips['recall']})")
    if build["scatter_rows3_inplace"] != mips["n_waves"]:
        raise SystemExit(f"K4a launched {build['scatter_rows3_inplace']} times over {mips['n_waves']} mips-96d waves")
    if build["packed_adj_update_inplace"] or build["fused_update_inplace"]:
        raise SystemExit(f"the mips-96d build launched K1 or K2: {build}")
    if mips["launches"]["lut16"]["adc16_score_kernel"] == 0:
        raise SystemExit("the mips-96d LUT16 serve launched no K6")
    off = adv.get("port_minus_jax", {})
    if any(abs(d) > PARITY_SLACK for d in off.values()):
        raise SystemExit(f"clustered-adversarial recall differs from the JAX figures by more than {PARITY_SLACK}: "
                         f"{off}")
    return result


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
    budgets = ltm._FUSED_BUILD_BUDGET, ltm._FUSED_SERVE_BUDGET
    try:
        path = os.path.join(tmp, "ltm.jvtpu")
        free_gb = shutil.disk_usage(tmp).free / 2**30
        # the base layer takes the packed (K3) regime, and the save streams
        # the fused layout from the host, as a corpus beyond the budgets does
        ltm._FUSED_BUILD_BUDGET = ltm._FUSED_SERVE_BUDGET = 0
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
        save = "device" if provider.supports_fused else "host"  # the host branch returns no fused tables
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
        ltm._FUSED_BUILD_BUDGET, ltm._FUSED_SERVE_BUDGET = budgets
        shutil.rmtree(tmp, ignore_errors=True)

    result = {
        "phase": "ltm_path", "n": n, "dim": 128, "regime": regime, "save": save, "n_waves": n_waves,
        "loader_calls": loads[0],
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
    if save != "host":
        raise SystemExit("the LTM save kept the fused tables on the device, not the host-streamed layout")
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
                   help="corpus size of the mips-96d path; the other paths run at min(n, 200,000)")
    args = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    n_earlier = min(args.n, EARLIER_N)

    phase_env()
    phase_build()
    kernels = phase_kernel_check()
    kernels[3:3] = phase_scatter_check(np.random.default_rng(4321))
    robust = phase_robustness(args.n, min(args.n, ADVERSARIAL_N), dev)
    ltm = phase_ltm_path(n_earlier, dev)
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
    lut16_20k = phase_lut16_parity(dev)
    micro = phase_micro(dev)

    main_path = {"packed_adj_update_inplace": ("sq4_path",), "fused_update_inplace": ("sq4_path",),
                 "packed_adj_only_update_inplace": ("ltm_build",),
                 "scatter_rows3_inplace": ("mips_96d_build",), "scatter_rows_inplace": (), "scatter_slots_inplace": (),
                 "adc_score_kernel": ("default_config_build", "default_config_serve"),
                 "adc16_score_kernel": ("lut16_serve", "micro")}
    mips, adv = robust["mips_96d"]["launches"], robust["clustered_adversarial"]["launches"]
    for k in kernels:
        name = k["name"]
        by_path = {"mips_96d_build": mips["build"][name], "mips_96d_serve": mips["serve"][name],
                   "lut16_mips_1m": mips["lut16"][name],
                   "adversarial_build": adv["build"][name], "adversarial_serve": adv["serve"][name],
                   "sq4_path": sq4["launches"][name], "lut16_serve": sq4["lut16"]["launches"][name],
                   "lut16_20k": lut16_20k["launches"][name], "micro": micro["launches"][name],
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
