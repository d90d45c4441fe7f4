"""Drive the PyTorch/CUDA port's paths once on one GPU.

    python3 chip_smoke.py              # every path at 200k
    python3 chip_smoke.py --n 50000    # a shorter rehearsal: every path at 50k

Phases, each printing one JSON line:

1. environment: torch / CUDA / nvcc versions and the card's name and power
   limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them; exits
   non-zero without a CUDA device;
2. kernel build: compiles ``jvector_tpu_torch/csrc/*.cu``, one nvcc per
   source, all started together;
3. kernel check: K1 (packed adjacency), K3 (packed adjacency without the
   w2 table) and K2 (fused SQ4 code table) against their plain PyTorch
   twins at the 1M build shapes (bit-exact, ``torch.equal``), with appends
   on every wave row, enforce images on wave rows and K2's drop markers
   inside the sorted stream; beside each one's event time, its device
   time from 20 back-to-back calls under ``torch.profiler`` (and the
   kernels each call launched: one, or the script fails), the host time
   per wrapper call and the device time of the least launch (the floor); K4a (row
   scatter into the ``[1,048,576, 24, 128]`` uint8 fused table of the 1M
   mips-96d build, B = 17,408 rows with dropped and duplicate-identical
   rows), K4b (the same scatter on that table viewed 2-D, and on a
   ``[1,048,576, 64]`` float32 table) and K7 (slot scatter on the float32
   table, and 48-byte slots on the 2-D uint8 view) against their twins
   (bit-exact), each with its device us and its host us a wrapper call,
   and the check's seconds; and K5 (PQ ADC) against ``adc_score_ordered`` (its own
   summation order: bit-exact, ``torch.equal``) at every ``K5_SHAPES``
   shape, printing the wrapper's launch plan of each and, beside the
   event times, the kernel's device us with a cold L2 (256 MB written
   before each call), a clean-cold one (written, then read) and a warm
   one, and its share of the byte bound; and K6 (LUT16
   ADC) against ``adc16_ordered`` (the Pallas kernel's summation order:
   bit-exact, ``torch.equal``) and within ``torch.allclose(rtol=1e-5,
   atol=1e-4)`` of ``adc16_ref`` (the CPU paths' twin, another order) at
   every ``K6_SHAPES`` shape (the LUT16 serves' waves and entry scores,
   the micro's, the shared-table cosine norm, an unaligned shape), printing
   each shape's launch plan, its device us (back to back) and host us a
   wrapper call and its share of the sector bound (the 32-byte table
   sectors its gathers touch, about half of each table at the entry
   scores' C = 1; the whole-table bound beside it), its plain version
   ``adc16_ref``; each with the median time of 20 runs from CUDA events,
   beside its bound (bytes over 3.35 TB/s) and the PyTorch call that
   computes the same function, where one does (K4a / K4b: ``index_copy_``,
   K7: ``index_put_``, K5: gather + sum, K6: a gather per nibble + sum);
   last, K8 (the beam step's frontier filter) against its twin
   ``frontier_filter_ref`` (each output ``torch.equal``, one launch a
   call) at every ``K8_SHAPES`` shape (the two benchmark cells' serve
   waves, the SQ4 cell's repacked tail, the build's wave search, a
   filtered widening whose beam and ring outgrow one tile), with its byte
   and compare bounds, and at the two serve shapes its event ms beside
   the twin's, its device us (and the kernels a call launched), the
   twin's device us and its host us a wrapper call;
4. robustness (``bench.py``'s robustness corpora through
   ``jvector_tpu_torch.bench.headline``): **mips-96d at ``--n``** (the main
   path; 200,000 by default, cut from bench.py's 1M so the script stays
   within its time, to 500k with the search-API phase and to 200k with
   the BASELINE-configs phase; the kernel checks keep the 1M shapes): ``synthetic_dataset(n, dim=96,
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
   launched there, if K6 did not launch in the LUT16 serve or launched
   at a shape that no ``K6_SHAPES`` entry checks, or if the
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
   ``build_graph`` at ``GraphConfig(max_degree=32, ef_construction=100)``
   (its middle wave is applied a second time to clones of the tables
   through K1's and K2's twins, which must give the same tables bit for
   bit; the line records that wave's streams and the kernels' device time
   on them), SQ4 compute/encode/provider_for_graph, exact ground truth for 1024
   queries, two-pass SQ4 + exact-rerank search in 4096-query waves at beam
   100 and at the smallest beam of bench.py's list that clears recall
   0.955; then the **LUT16 serve** over the same graph
   (``experiments/search_sweep_1m.py``'s ``lut16_64``: PQ at m = 64, K = 16,
   codes packed two a byte, ``build_fused_codes_lut16``, LUT16 first pass
   through K6 + exact rerank at ``rerank_k = beam``) at beams 40, 100 and
   200, QPS at beam 100, with the PQ and fused-table seconds and bytes.
   Fails if the real wave's tables differ, if recall@10 at beam 100 is
   below 0.95 (SQ4 or LUT16), if K1's or K2's launch count over the build
   differs from the number of build waves, or if K6 did not launch in the
   LUT16 serve or launched at a shape that no ``K6_SHAPES`` entry checks.
   Then, on the same graph, corpus and ground truth, the
   **lifecycle** (``"phase": "lifecycle"``, each step's seconds and the
   kernels it launched): (1) ``mark_deleted`` on a tenth of the nodes
   (20,000 at 200k, a sorted draw from ``default_rng(11)``), searched at
   beam 100 (SQ4 code-row first pass + exact rerank, as every lifecycle
   search but NN-descent's): no deleted id may come back, and the caller's
   graph must be unchanged (sha256 of its tables) and still serve at 0.95;
   (2) ``remove_deleted``: no edge into a deleted node, a live entry, and
   recall@10 over 1024 queries against the exact top-10 of the live nodes
   >= 0.95 and within 0.02 of the tombstoned graph's before the splice
   (the same edges as before the delete, deleted results filtered), and
   at beam 20, where the SQ4 path is below 1.0, not more than 0.02 under
   the tombstoned graph's at beam 20; the live rows' average degree above
   what dropping the edges into deleted nodes would leave them (the 2-hop
   repair adds edges; recall alone barely tells the two apart,
   ``experiments/torch_splice_drop_only_cpu.py``);
   (3) ``add_nodes`` re-inserts the deleted vectors as new ordinals:
   recall@10 against the full corpus's ground truth, ids mapped, >= 0.95,
   at beam 20 not more than 0.02 under the tombstoned graph's, and the
   spliced graph unchanged (sha256); (4) ``nn_descent_build`` over
   the same vectors, recall@10 (exact first pass) at beams 50 and 100
   against their own exact top-10, held at beam 100 within 0.03 of the JAX
   package's (``experiments/torch_lifecycle_cpu.py``, at 200k only);
   (5) the spliced graph (``renumber=False``: its tombstones are the live
   mask) and the segment saved with inline vectors and merged by
   ``compact_on_disk`` in waves of 1024 under a 128 MiB ledger budget:
   the whole corpus again, mapped through the mappers; (6)
   ``DeviceTierIndex.load`` of the merged file, recall@10 at the SQ4
   path's beams and QPS at beam 100 over the 8192 queries in 4096-query
   waves (recall at beam 100 >= 0.95), ``hbm_bytes`` beside the phase's
   ``torch.cuda.max_memory_allocated``; (7) ``compact_indexes(pq=...)`` at
   20,000 (the 128-d corpus of phase 8, three segments of 8,334 / 6,666 /
   5,000 built by the port, a base PQ at m = 16, K = 256 on the first,
   retrained on the merged sample; every graph score on codes, so K5
   launches: ``launches_by_path["lifecycle_pq_compaction"]``, by shape in
   ``k5_launches_by_shape``), recall@10 with exact rerank at beams 50 and
   100, at beam 100 no more than 0.03 under the lowest of the JAX
   package's eight retrain seeds; then the same merge with
   ``retrain=False`` on codebooks both packages draw alike without
   training (``launches_by_path["lifecycle_pq_compaction_carried"]``),
   held at beam 100 within 0.01 of the JAX package's (both checks at 200k
   runs only); (8) ``ProductQuantization.compute``
   twice from one seed on 131,072 rows, plain PQ (m = 16, d = 128) and
   config 3's anisotropic PQ (m = 24, d = 96, T = 0.2): the codebooks must
   be bit-equal (``torch.equal``);
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
   the launches over them, then its compaction row (``run_compact_micro``
   at ``n`` = :data:`MICRO_COMPACT_N`: two SQ4 segments of 12,500 at d = 64
   stream-built, ``compact_on_disk`` timed; its seconds and launches
   apart); fails if K5 or K6 did not launch, or K6 at a shape that no
   ``K6_SHAPES`` entry checks;
10. search API, one ``"phase": "search_api"`` line per graph, each part
   run before its graph is freed (ground truth exact, on the card; recall
   over 1024 queries, seconds over one 4096-query wave): in phase 5, the
   host-served file's filtered search at selectivity 0.01 (the streamed
   in-loop path, recall floor 0.90) and threshold search, and
   ``peak_split``, the serve's device peak by allocation site; in phase 6,
   on the SQ4 graph (SQ4 first pass + exact rerank at beam 100), filtered
   search (four pops a step) with accept masks from ``default_rng(0)`` at
   selectivities 0.10, 0.01 (the in-loop channel, floor 0.90) and 0.001
   (200 nodes: the brute path, or it fails), threshold search at the median over the
   queries of the exact 10th-best score (exact first pass; fails on a
   result below it), resume of page 2 with and without the state (fails
   on a repeated page-1 id) and multi-index search over four SQ4 shards of
   25,000 built from the corpus's first :data:`MULTI_N` vectors, stacked
   and sequential, recall against the exact top-10 over those vectors
   (floor 0.90); in
   phase 7, ``refine_graph`` and ``rescore_graph`` over the 200k base
   layer in chunks of 1024 (fails if recall@10 at beam 100 falls by more
   than the JAX package's own refine lowers it plus 0.01, at n = 200,000,
   if the rescore changes a row's id set or leaves it unsorted, or if K5
   did not launch in either).

11. BASELINE configs 3 and 4 (``"phase": "baseline_configs"``), as
   ``experiments/baseline_configs_demo.py`` defines them, through the
   port's public API: beams 20/30/40/60/80/120 with recall@10 over 512
   queries printed at every beam, the first beam reaching 0.95 as the
   operating beam and its QPS over 8192 queries in 1024-query waves.
   **Config 3** (deep1M-like: ``synthetic_dataset(n, 96, n_queries=8192,
   k=10, sim="dot_product", n_clusters=max(64, n // 500), seed=7)``, base
   and queries L2-normalized, exact dot-product ground truth on the card):
   ``build_graph(base, "dot_product", GraphConfig(max_degree=32,
   ef_construction=100))`` (the fused loop's whole-row path, K4a once a
   wave), then on that graph with exact rerank at ``rerank_k = beam``: (a)
   anisotropic PQ (m = 24, K = 256, uncentred, T = 0.2) through
   ``build_fused_codes`` / ``FusedADCScoreProvider`` (K5 every beam step),
   (b) the same PQ with T = -1, (c) anisotropic SQ4
   (``encode_anisotropic(threshold=0.2)``) through ``provider_for_graph``
   beside plain SQ4.  **Config 4** (ada-002-like: the same at d = 1536,
   ``sim="cosine"``, seed 8, built and served as dot product): the SQ4
   build, which at MP = 768 takes the packed loop (K1 and K2 once a wave
   on 43,008-byte fused rows; its middle wave re-applied through their
   twins, bit-equal or it fails), then a BQ first pass with NVQ rerank and
   with FP32 rerank.  Both run first at n = 20,000, held at beams 60 and
   120 within 0.03 of the JAX package for (a), (c) and config 4
   (``experiments/torch_baseline_configs_cpu.py``), then at
   ``min(--n, 200,000)`` (config 3 cut from the demo's 1M for the
   script's time; 200,000 is config 4's own size), where recall@10 at
   beam 120 must reach 0.90 for (a) and config 4 (a floor for a broken
   path; ``README.md``'s TPU v5e figures are printed beside, unchecked).
   Between them, ``jvector_tpu_torch.bench.grid.Grid`` on config 3's 20k
   corpus (anisotropic PQ construction; search compression PQ, BQ and
   FUSED_PQ; reranking FP32 and NVQ; topK 10 at overquery 2 and 6) with a
   compressor cache in a temporary directory, run twice: the second run
   must train nothing.  One 1024-query wave of serve (a) and of config
   4's serve is timed with its first pass alone and whole, and profiled
   whole (``torch.profiler``) for the device-busy share and the kernels
   with the most device time.  Fails also if K4a's launches over a config-3
   build, or K1's or K2's over a config-4 build, differ from its waves, if
   serve (a) launched no K5, or if a result has fewer than 10 ids or
   non-finite scores.  Phase 3 checks K2 at config 4's table
   (212,992 x 43,008 bytes) and K5 at config 3's M = 24 as well.

12. sharding (``"phase": "sharding"``): a mesh of all visible cards if
   there are at least four, else ``["cuda:0"] * 4`` (four shards on the
   one card this script uses); 100,000 x 128 of the SQ4 path's corpus
   family (``synthetic_dataset(100_000, 128, n_queries=4096, k=10,
   n_clusters=200, seed=0)``, ground truth over the first 1024 queries)
   built by ``sharded_build`` at ``GraphConfig(max_degree=32,
   ef_construction=100)``: the packed regime, four shards of 25,000, K1
   and K2 once per shard per wave (4 x 49 = 196, or it fails,
   ``launches_by_path["sharding"]``); ``sharded_brute_force`` over the
   mesh must give ``_exact_topk``'s top-10 as a set (an id may differ
   only at a float tie with the 10th); ``sharded_graph_search`` at beams
   20 / 50 / 100 (``rerank_k`` = beam): recall@10 >= 0.95 at beam 100 and
   within 0.02 of the JAX package's figure on the same corpus and a
   4-device CPU mesh (``experiments/torch_sharding_cpu.py``), QPS at beam
   100 over 65,536 queries in 4096-query waves, one ``floor_slack`` = 0.0
   run printed beside the JAX figure; ``sharded_search`` of shard 0's
   graph over the mesh must equal a one-device ``search``;
   ``save_sharded`` -> ``load_sharded`` must keep the ids, and shard 0's
   file served by ``HostGraphIndex`` must reach 0.90 against shard 0's
   exact top-10; ``sharded_build_on_disk`` of 2 x 20,000 rows (the first
   40,000) served by ``ShardedHostIndex`` at beam 64 (>= 0.90), a 10%
   filter (no id outside the mask), a re-run that must leave the shard
   files' sha256 and the loader untouched, ``load_sharded`` onto a
   2-entry mesh (>= 0.90 at beam 64); last ``entry.dryrun_multichip`` on
   the mesh's devices.  The line holds each step's seconds
   (``StepTimer``), the launches by step and each card's peak memory
   (``device_memory_stats``).
13. harness (``"phase": "harness"``): the catalog
   ``yaml-configs/dataset-catalogs/local.yml`` read by the port's YAML
   reader, its ``synth-100k`` opened with the ground truth on the card
   (100,000 x 128, 2,048 queries, k = 100, seed 0, 200 clusters); an
   ``IPCService`` on a socket in a temporary directory, on the card, and
   one ``IPCClient`` session: ``CREATE 128 euclidean 32 100``, rows
   0-79,999 in 80 ``WRITE`` commands of 1,000 (each float as ``'%.9g'``,
   so the float32 values arrive bit for bit), ``OPTIMIZE`` (``OK 80000``;
   the default SQ4 build in waves of 256: K1 = K2 = 313 launches or it
   fails), rows 80,000-99,999, ``OPTIMIZE`` again (``OK 100000``:
   ``add_nodes``), ``SEARCH 100 10`` over the first 1,024 queries in four
   commands of 256 (recall@10 >= 0.95 against the catalog's ground
   truth), ``MEMORY`` (an integer between the adjacency's plus the
   vectors' bytes and ``torch.cuda.max_memory_allocated()``), ``SAVE``;
   a second connection ``LOAD``s it (``OK 100000``) and the same
   ``SEARCH`` commands must give identical ``RESULT`` lines; any
   ``ERROR`` reply fails.  Then the bench CLI in-process,
   ``jvector_tpu_torch.bench.__main__.main(["synth-100k", "--config",
   "yaml-configs/sq4.yml", "--catalog", <local.yml>, "--output", <tmp>])``:
   exit code 0, one CSV and one JSONL, three rows (topK 10 x overquery 2 /
   4 / 6, SQ4 serve, FP32 rerank), K1 = K2 = 196 (waves of 512), recall@10
   >= 0.95 at overquery 6 and every row within 0.02 of the JAX CLI's on
   the same entry and YAML (``experiments/torch_harness_cpu.py``).  The
   line holds each IPC step's seconds, WRITE vectors/s, SEARCH QPS and
   the launches by step (``launches_by_path``: ``ipc_optimize``,
   ``ipc_add_nodes``, ``ipc_search``, ``bench_cli``).

Phases run in this order, phase 10's parts inside phases 5, 6 and 7.  Kernel
launch counts are read per path: set to 0 just before a path, read just
after; K5's also by shape (``"QxCxM"``: ``k5_launches_by_shape``) on the
default config's build, serve, refine and rescore, on every config-3
and config-4 serve and on the lifecycle's two PQ-sidecar compactions.
Float32 matrix products run in full float32: TF32 is switched off for
matmuls and cuDNN.  The run uses one card (``CUDA_VISIBLE_DEVICES``
is the first that ``CUDA_VISIBLE_DEVICES`` lists, else card 0).  Imports
nothing of JAX.  The last line is the JSON
``{"ok": true, "device": {...}}``; any failure raises before it.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

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
# search API phase: accept-mask selectivities (0.001 of 200k is 200 nodes,
# under the brute cutoff max(4 * beam, 512)), the recall floor of filtered
# searches (tests/test_filtered_search.py's; the host's, tests/test_host_graph.py's),
# the multi-index shards and the refine's recall slack (tests/test_search_api.py's)
SELECTIVITIES = (0.10, 0.01, 0.001)
FILTER_FLOOR = 0.90
FILTER_EXPAND = 4  # pops a step in the filtered searches (the host serve's expand)
API_BEAM = 100
MULTI_SHARDS, MULTI_N = 4, 100_000  # the multi-index: four shards over the corpus's first MULTI_N vectors
MICRO_COMPACT_N = 25_000  # the micro's compaction row: two segments of 12,500 (run_compact_micro's default is 2 x 25k)
REFINE_SLACK = 0.01
# recall@10 at beam 100 of the JAX package's default-config graph before and
# after refine_graph (its PQ provider, chunks of 1024) over the first 1024 of
# this script's 200k queries (experiments/torch_refine_cpu.py --n 200000
# --queries 8192): the reference's own PQ-scored refine lowers recall on
# this corpus family (at 20k 0.5096 -> 0.4879, and the port refining the
# same graph gives the same figures), so the port's drop is held to the
# reference's plus REFINE_SLACK
JAX_REFINE_200K = (0.40654296875, 0.40537109375)
# BASELINE configs 3 and 4 (experiments/baseline_configs_demo.py): its
# beams, operating rule (the first beam whose recall@10 over 512 queries
# reaches 0.95, QPS over 8192 queries in 1024-query waves), sizes, a floor
# for a broken path at 200k, and the JAX package's recall@10 at n = 20,000
# on the same corpora, quantizers and serves (experiments/torch_baseline_configs_cpu.py)
BASELINE_BEAMS = (20, 30, 40, 60, 80, 120)
BASELINE_N = 200_000
BASELINE_PARITY_N = 20_000
BASELINE_GT_QUERIES = 512
BASELINE_WAVE = 1024
BASELINE_QUERIES = 8192
BASELINE_FLOOR_200K = 0.90
BASELINE_PARITY_BEAMS = (60, 120)
JAX_BASELINE_20K = {
    "c3_aniso_pq": {20: 0.6994140625, 30: 0.817578125, 40: 0.8826171875, 60: 0.94921875, 80: 0.976171875,
                    120: 0.9953125},
    "c3_plain_pq": {20: 0.4986328125, 30: 0.6140625, 40: 0.7, 60: 0.8126953125, 80: 0.8779296875,
                    120: 0.9564453125},
    "c3_aniso_sq4": {20: 0.9654296875, 30: 0.9955078125, 40: 0.9994140625, 60: 0.9998046875, 80: 0.9998046875,
                     120: 1.0},
    "c3_plain_sq4": {20: 0.784375, 30: 0.8826171875, 40: 0.9275390625, 60: 0.9759765625, 80: 0.989453125,
                     120: 0.9978515625},
    "c4_bq_nvq": {20: 0.8005859375, 30: 0.8916015625, 40: 0.9375, 60: 0.973828125, 80: 0.9841796875,
                  120: 0.987890625},
    "c4_bq_fp32": {20: 0.801171875, 30: 0.8955078125, 40: 0.943359375, 60: 0.9837890625, 80: 0.9955078125,
                   120: 0.999609375},
}
BASELINE_PARITY_HELD = ("c3_aniso_pq", "c3_aniso_sq4", "c4_bq_nvq")
# the lifecycle phase (inside the SQ4 path, on its corpus, graph and ground
# truth): a tenth of the nodes deleted (a sorted draw from
# default_rng(LIFECYCLE_SEED)), spliced out and inserted again; the same
# vectors as an NN-descent segment; the spliced graph and that segment
# compacted on disk in waves of LIFECYCLE_WAVE under LIFECYCLE_BUDGET bytes
# of the compactor's own device tensors (its ledger); the merged file
# served by the device tier; a 20k PQ-sidecar compaction; PQ trained twice
# from one seed on LIFECYCLE_DETERMINISM_ROWS rows.  The JAX package's
# recall@10 for the NN-descent segment (exact first pass) and the 20k
# PQ-sidecar compaction (ADC first pass, exact rerank at rerank_k = beam),
# at beams 50 and 100 over 1024 queries, come from
#     JAX_PLATFORMS=cpu python experiments/torch_lifecycle_cpu.py --seeds 8
# (at --n 200000 only): NN-descent at beam 100 within PARITY_SLACK; the
# retrained compaction at beam 100 no more than PARITY_SLACK under the
# lowest of the retrain's k-means seeds 0-7 (the port cannot draw
# jax.random's samples, and the port's own eight seeds spread 0.4096-0.4506,
# experiments/torch_pq_compaction_seeds.py on the card, against the JAX
# package's 0.4238-0.4411); the compaction with retrain=False on codebooks
# both packages draw alike without training (_carried_codebooks) at beam
# 100 within LIFECYCLE_CARRIED_SLACK of the JAX package's.  The splice and
# the insert are held at LIFECYCLE_LOW_BEAM too, where recall is below 1.0
LIFECYCLE_SEED = 11
LIFECYCLE_WAVE = 1024
LIFECYCLE_BUDGET = 128 * 2**20
LIFECYCLE_SPLICE_SLACK = 0.02
LIFECYCLE_LOW_BEAM = 20
LIFECYCLE_CARRIED_SLACK = 0.01
LIFECYCLE_DETERMINISM_ROWS = 131_072
LIFECYCLE_PQ_SPLITS = ((0, 8_334), (8_334, 15_000), (15_000, 20_000))
JAX_NNDESCENT_RECALL_20K = {50: 0.92060546875, 100: 0.945703125}
JAX_PQ_COMPACTION_RECALL_20K = {"seed_0": {50: 0.30087890625, 100: 0.44111328125},
                                "mean": {50: 0.28896484375, 100: 0.43182373046875},
                                "min": {50: 0.2818359375, 100: 0.423828125},
                                "max": {50: 0.30087890625, 100: 0.44111328125}}
JAX_PQ_CARRIED_RECALL_20K = {50: 0.5810546875, 100: 0.7779296875}
# README.md's figures for these configs: the JAX package on a TPU v5e at 1M
# (config 3) and 200k (config 4); printed beside the port's, never a target
README_TPU_V5E = {"c3_aniso_sq4": {"beam": 30, "recall": 0.9535, "qps": 34_814},
                  "c3_aniso_pq": {"beam": 120, "recall": 0.9625, "qps": 2_489},
                  "c4_bq_nvq": {"beam": 60, "recall": 0.9549, "qps": 23_412}}
# the sharding phase: SHARD_N vectors of the SQ4 path's corpus family
# (synthetic_dataset(SHARD_N, 128, n_queries=SHARD_QUERIES, k=10,
# n_clusters=max(64, SHARD_N // 500), seed=0)) built over a mesh of
# SHARD_COUNT shards, served at SHARD_BEAMS with rerank_k = beam, recall@10
# over the first GT_QUERIES queries, held at beam 100 to RECALL_FLOOR and
# within SHARD_PARITY_SLACK of the JAX package's recall on the same corpus
# and a 4-device virtual CPU mesh (experiments/torch_sharding_cpu.py, which
# also gives the floor_slack = SHARD_FLOOR_SLACK run's figure, printed
# unchecked); then SHARD_LTM_SHARDS larger-than-memory shards of
# SHARD_LTM_N // SHARD_LTM_SHARDS rows of the same corpus, served from the
# host at HOST_BEAM (HOST_RECALL_FLOOR) and filtered at SHARD_FILTER
SHARD_N = 100_000
SHARD_COUNT = 4
SHARD_QUERIES = 4096
SHARD_BEAMS = (20, 50, 100)
SHARD_PARITY_SLACK = 0.02
SHARD_FLOOR_SLACK = 0.0
SHARD_LTM_N, SHARD_LTM_SHARDS = 40_000, 2
SHARD_FILTER = 0.10
JAX_SHARDED_RECALL_100K = {20: 1.0, 50: 1.0, 100: 1.0}
JAX_SHARDED_FLOOR_RECALL_100K = 0.7826171875  # at beam 100, floor_slack 0.0
# the harness phase: the catalog's synth-100k (100,000 x 128, 2,048 queries,
# k = 100, seed 0, 200 clusters), read through the port's catalog and YAML
# reader; the IPC session writes HARNESS_IPC_FIRST rows in commands of
# HARNESS_WRITE_ROWS, OPTIMIZEs (the default SQ4 build in waves of
# HARNESS_IPC_WAVE, the service's CREATE), writes the rest and OPTIMIZEs
# again (add_nodes), then SEARCHes HARNESS_IPC_QUERIES queries in commands
# of HARNESS_IPC_CHUNK at ef 100, top 10; the bench CLI runs
# yaml-configs/sq4.yml (build waves of HARNESS_CLI_WAVE, GraphConfig's
# default) and each row is held within HARNESS_CLI_SLACK of the JAX CLI's
# row on the same entry and YAML (experiments/torch_harness_cpu.py --part
# cli: JAX on the CPU, its run HARNESS_JAX_CLI_SECONDS s)
HARNESS_DATASET = "synth-100k"
HARNESS_N, HARNESS_IPC_FIRST = 100_000, 80_000
HARNESS_WRITE_ROWS = 1_000
HARNESS_IPC_WAVE, HARNESS_CLI_WAVE = 256, 512
HARNESS_IPC_QUERIES, HARNESS_IPC_CHUNK = 1_024, 256
HARNESS_CLI_SLACK = 0.02
JAX_CLI_RECALL_100K = {2.0: 0.9664, 4.0: 0.9991, 6.0: 0.9999}  # topK 10, SQ4 + FP32 rerank, by overquery
HARNESS_JAX_CLI_SECONDS = 634.74


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


def device_us(fn, reps: int = 20) -> dict:
    """Device time per call of ``fn`` over ``reps`` back-to-back calls, from
    torch.profiler (the sum of the CUDA time of every kernel the calls
    launched, over ``reps``), and the kernels launched per call by name;
    None where the profiler recorded no device time in the window."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages() if e.self_device_time_total > 0]
    if not rows:
        return {"device_us": None, "kernels_per_call": None}
    return {"device_us": sum(t for _, t, _ in rows) / reps, "kernels_per_call": {k: c / reps for k, _, c in rows}}


def host_us(fn, reps: int = 200) -> float:
    """Host time per call of ``fn`` (the wrapper's checks, the ctypes call
    and the enqueue), from the host clock over ``reps`` calls unsynchronised."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / reps * 1e6


def launch_floor_us() -> float | None:
    """Device time of the least launch: one kernel that writes one 4-byte
    word (``zero_`` on a 1-element tensor)."""
    word = torch.zeros(1, dtype=torch.int32, device="cuda")
    return device_us(word.zero_, reps=100)["device_us"]


def event_us(fn, prep=None, reps: int = 20) -> float:
    """Device time of one call of ``fn`` in us from CUDA events, the median
    over ``reps``.  With ``prep``, it runs before every call outside the
    timed span (an L2 flush; it also keeps the host's enqueue out of the
    span).  Without it the calls run back to back behind a device spin (a
    warm L2), timed as one span."""
    fn()
    torch.cuda.synchronize()
    if prep is None:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)  # ~2.5 ms: the host enqueues every call before the first runs
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps * 1e3
    spans = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        prep()
        a.record()
        fn()
        b.record()
        spans.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in spans])) * 1e3


def kernel_us(fn, match: str, prep=None, reps: int = 20) -> float | None:
    """Device time per launch in us of the kernels whose name holds
    ``match`` over ``reps`` calls of ``fn`` (each after ``prep`` where one
    is given), from torch.profiler; None where the profiler recorded no
    such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if prep is not None:
                prep()
            fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.count) for e in prof.key_averages()
            if match in e.key and e.self_device_time_total > 0]
    return sum(t for t, _ in rows) / sum(c for _, c in rows) if rows else None


L2_FLUSH_BYTES = 256 * 2**20  # flushed through between calls for a cold L2: five times the H100's 50 MB


def cold_warm_us(fn, match: str | None = None, flush: torch.Tensor | None = None) -> dict:
    """``fn``'s device us a call: cold after a write of ``flush`` (256 MB of
    uint8) between calls, which leaves the L2 full of dirty lines whose
    write-back the call then pays for; clean-cold after a read of it; and
    warm, back to back.  From CUDA events, and where ``match`` names the
    kernel from torch.profiler (``device_*``)."""
    if flush is None:
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    write, read = flush.zero_, (lambda: flush.sum())
    out = {"event_cold_us": event_us(fn, write), "event_clean_cold_us": event_us(fn, lambda: (write(), read())),
           "event_warm_us": event_us(fn)}
    if match is not None:
        out["device_cold_us"] = kernel_us(fn, match, write)
        out["device_clean_cold_us"] = kernel_us(fn, match, lambda: (write(), read()))
        out["device_warm_us"] = kernel_us(fn, match)
    return out


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
    from jvector_tpu_torch.ops.kernels import _build, adc, adc16, frontier, packed_adj, scatter_rows

    t0 = time.time()
    sources = sorted(f for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        list(pool.map(_build.build, sources))
    for load in (packed_adj._lib, scatter_rows._lib, scatter_rows._scatter_entry, adc._lib, adc16._entry,
                 frontier._entry):
        load()
    emit({"phase": "kernel_build", "sources": sources, "seconds": time.time() - t0})


def bound_ms(n_bytes: int) -> float:
    """Least time to move ``n_bytes`` through device memory, in ms."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def _k1_inputs(rng: np.random.Generator, dev, n_cap: int = 1_048_576):
    """K1 at the 1M main-path shapes: N_cap = 1,048,576 rows, W = 512,
    P = W*(M+1) = 16,896 patches sorted by row, with dropped rows, runs of
    several patches per physical row and enforce images; every wave row
    takes appends and 16 enforce images land on wave rows (the hazards of
    the one-owner design), as the builder's waves give them."""
    w, m = 512, 32
    n_pr = n_cap // 8
    big = 2**30
    adj = torch.randint(-(2**31), 2**31 - 1, (n_pr, 8, 128), dtype=torch.int32, device=dev)
    w2t = torch.randint(-(2**31), 2**31 - 1, (n_pr, 8, 128), dtype=torch.int32, device=dev)
    a0 = int(rng.integers(0, n_pr - w // 8))
    a_rows = np.arange(a0, a0 + w // 8, dtype=np.int32)
    a_rows[3], a_rows[7] = -1, n_pr  # dropped
    # appends: distinct (row, slot) pairs, several per row, one logical row
    # of each wave row first; enforce images on rows that take no append
    # (the graph builder's contract), 16 of them on wave rows
    live = a_rows[(a_rows >= 0) & (a_rows < n_pr)]
    wave_app = live * 8 + rng.integers(0, 8, live.size)
    wave_logical = (live[:, None] * 8 + np.arange(8)).ravel()
    wave_er = rng.choice(np.setdiff1d(wave_logical, wave_app), 16, replace=False)
    others = rng.choice(n_cap, 8000 + w + 1000, replace=False)
    others = others[~np.isin(others, wave_logical)][: 8000 + w - live.size - 16].astype(np.int32)
    app_rows = np.concatenate([wave_app, others[: 8000 - live.size]]).astype(np.int32)
    er_rows = np.concatenate([wave_er, others[8000 - live.size:]]).astype(np.int32)
    mult = rng.integers(1, 7, app_rows.size)
    keys, slots = [], []
    for r, k in zip(app_rows, mult):
        keys += [r] * int(k)
        slots += list(rng.permutation(64)[:k])
    n_app = w * m
    keys, slots = np.array(keys[:n_app], np.int32), np.array(slots[:n_app], np.int32)
    keys[rng.random(n_app) < 0.05] = big  # dropped appends
    er_key = er_rows.copy()
    er_key[16:][rng.random(w - 16) < 0.1] = big  # enforce rows not taken
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


def _k2_inputs(rng: np.random.Generator, dev, n_cap: int = 1_048_576, t3: int = 32, mp: int = 64):
    """K2 at the 1M main-path shapes: a [1,048,576, 32, 128] uint8 table
    (4 KB rows, MP = 64), W = 512 wave images (8 of them on enforce rows),
    W*M = 16,384 slot patches sorted by row (runs of several slots per row,
    on every other wave row too) with the builder's drop markers (-1 for an
    enforce row's whole run and for some runs' overflow tails, inside the
    sequence; 2**30 for the invalid tail) and W enforce images.  ``t3`` and
    ``mp`` give other row widths (BASELINE config 4: T = 336, MP = 768, a
    43,008-byte row of 56 slots, on a 212,992-row table)."""
    w, m = 512, 32
    n_slots = t3 * 128 // mp
    big = 2**30
    table = torch.randint(0, 256, (n_cap, t3, 128), dtype=torch.uint8, device=dev)
    w0 = int(rng.integers(0, n_cap // w)) * w
    wave_rows = np.arange(w0, w0 + w, dtype=np.int32)
    wave_rows[5], wave_rows[9] = -1, n_cap
    live = wave_rows[(wave_rows >= 0) & (wave_rows < n_cap)]
    er_on_wave = rng.choice(live, 8, replace=False)
    others = rng.choice(n_cap, 5000 + w, replace=False)
    others = others[~np.isin(others, wave_rows)].astype(np.int32)
    er_rows = np.concatenate([er_on_wave, others[: w - 8]]).astype(np.int32)
    er_rows[8:][rng.random(w - 8) < 0.1] = -1
    targets = np.sort(np.concatenate([np.setdiff1d(live, er_on_wave), others[:100], others[w:w + 3600]]))
    p = w * m
    er_set = set(er_rows.tolist())
    keys, slots = [], []
    for r in targets:
        k = int(rng.integers(1, 7))
        run = [r] * k
        if r in er_set:
            run = [-1] * k  # an enforce row's run
        elif rng.random() < 0.1:
            run[-1] = -1  # a dropped tail patch
        keys += run
        slots += list(rng.permutation(n_slots)[:k])
    assert len(keys) < p - 400  # every target's run fits, then the invalid tail
    keys = np.array((keys + [big] * p)[:p], np.int32)
    slots = np.array((slots + [0] * p)[:p], np.int32)

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
    times (kernel, twin, the one PyTorch call of ``library(table)``; the
    kernel's device us and host us a call), the bound from
    :func:`_scatter_bytes` and the check's seconds."""
    t0 = time.time()
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
    dev_us = device_us(lambda: kernel(kt, *args))["device_us"]
    host = host_us(lambda: kernel(kt, *args))
    del kt, rt
    return {"kernel": what, "table": list(table.shape), "dtype": str(table.dtype).replace("torch.", ""),
            "B": int(args[0].shape[0]), "payload_row_bytes": row_bytes, "landed": landed, "bit_exact": exact,
            "max_abs_err": err, "rows_changed": changed, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "device_us": dev_us, "host_us": host, "bytes": n_bytes, "bound_ms": bound_ms(n_bytes),
            "seconds": time.time() - t0}


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
    return [{"name": name, "case": f"{row['dtype']} {row['table']}, {row['payload_row_bytes']}-byte items",
             "route": "cuda", "source": "jvector_tpu_torch/csrc/scatter_rows.cu",
             "replaces": f"jvector_tpu/ops/pallas/scatter_rows.py:{line}",
             "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
             "bound_ms": row["bound_ms"], "bound_by": "bytes", "library_ms": row["library_ms"],
             "device_us": row["device_us"], "host_us": row["host_us"]}
            for name, line, row in (("scatter_rows3_inplace", 82, k4a), ("scatter_rows_inplace", 54, k4b_u8),
                                    ("scatter_rows_inplace", 54, k4b_f32), ("scatter_slots_inplace", 189, k7_f32),
                                    ("scatter_slots_inplace", 189, k7_u8))]


K8_SHAPES = {  # (Q, E, R, L, T) of the beam step's frontier filter at each caller's shape
    "bq_serve": (10_000, 1, 56, 90, 256),  # angular-bq-batch: 10,000-query waves, beam 90
    "sq4_serve": (10_000, 1, 56, 30, 128),  # euclidean-sq4-batch: beam 30
    "sq4_tail": (2_496, 1, 56, 30, 128),  # its repacked tail
    "build": (512, 2, 56, 100, 256),  # the build's wave search (efConstruction 100, two pops a step)
    "filtered_widening": (1_024, 1, 56, 1_600, 3_200),  # beam and ring beyond one tile of shared memory
}
K8_ACTIVE = {"bq_serve": 0.46, "sq4_serve": 0.68}  # the cells' lane use (a pop slot that pops), else 0.7
K8_TIMED = ("bq_serve", "sq4_serve")
INT32_COMPARES_PER_S = 132 * 64 * 1.98e9  # H100 SXM: 64 int32 lanes an SM at the 67 TFLOP/s float32 clock


def frontier_case(rng: np.random.Generator, q: int, e: int, r: int, l: int, t: int, active_share: float = 0.7):
    """A beam step's frontier inputs as numpy arrays ``(nbrs [Q, E * R],
    active [Q, E], beam [Q, L], history [Q, T])``: ids drawn from a range
    about 1.5 x L + T wide, so that about half the candidates meet an id of
    their row's beam or history; a fifth of the candidates repeat an
    earlier one of their row; -1 in every id input; a share
    ``active_share`` of the pops active, and none in the middle row."""
    c = e * r
    v = max(16, (l + t) * 3 // 2)
    nbrs = rng.integers(0, v, (q, c)).astype(np.int32)
    src = rng.integers(0, c, (q, c))
    again = (rng.random((q, c)) < 0.2) & (src < np.arange(c))
    nbrs = np.where(again, np.take_along_axis(nbrs, src, 1), nbrs)
    nbrs[rng.random((q, c)) < 0.15] = -1
    active = rng.random((q, e)) < active_share
    active[q // 2] = False
    beam = rng.integers(0, v, (q, l)).astype(np.int32)
    beam[rng.random((q, l)) < 0.2] = -1
    history = rng.integers(0, v, (q, t)).astype(np.int32)
    history[rng.random((q, t)) < 0.3] = -1
    return nbrs, active, beam, history


def _k8_check(rng: np.random.Generator, name: str, timed: bool) -> dict:
    """K8 at ``K8_SHAPES[name]``: each output ``torch.equal`` to its twin's,
    one launch, the wrapper's plan, the byte bound (every input read once,
    every output written once) and the compare bound (each candidate
    against its row's beam, history and earlier candidates); where
    ``timed`` the event ms of the wrapper and of the twin, the kernel's
    device us and the kernels a call launched (back to back), the twin's
    device us, and the host us a wrapper call."""
    from jvector_tpu_torch.ops.kernels.frontier import frontier_filter, frontier_filter_ref, plan

    q, e, r, l, t = K8_SHAPES[name]
    c = e * r
    nbrs, active, beam, history = (torch.as_tensor(x, device="cuda")
                                   for x in frontier_case(rng, q, e, r, l, t, K8_ACTIVE.get(name, 0.7)))
    before = frontier_filter.launches
    got = frontier_filter(nbrs, active, r, beam, history)
    launched = frontier_filter.launches - before
    want = frontier_filter_ref(nbrs, active, r, beam, history)
    torch.cuda.synchronize()
    n_bytes = sum(x.numel() * x.element_size() for x in (nbrs, active, beam, history)) + q * c * 9
    compares = q * c * (l + t) + q * c * (c - 1) // 2
    row = {"shape": {"Q": q, "E": e, "R": r, "L": l, "T": t}, "plan": dict(zip(("k", "tile"), plan(c, l, t))),
           "bit_equal": all(torch.equal(a, b) for a, b in zip(got, want)), "launches": launched,
           "fresh_share": float(got[0].float().mean()), "active_share": float(active.float().mean()),
           "bytes": n_bytes, "bound_ms": bound_ms(n_bytes), "compares": compares,
           "compare_bound_ms": compares / INT32_COMPARES_PER_S * 1e3}
    if timed:
        call = lambda: frontier_filter(nbrs, active, r, beam, history)  # noqa: E731
        twin = lambda: frontier_filter_ref(nbrs, active, r, beam, history)  # noqa: E731
        row["ms"], row["plain_ms"] = median_ms(call), median_ms(twin)
        dev = device_us(call)
        row["device_us"], row["kernels_per_call"] = dev["device_us"], dev["kernels_per_call"]
        row["plain_device_us"] = device_us(twin)["device_us"]
        row["host_us"] = host_us(call)
    return row


def phase_frontier_check(rng: np.random.Generator) -> dict:
    """K8 against its twin at every ``K8_SHAPES`` shape, timed at the two
    cells' serve shapes; fails unless each is bit-equal in one launch."""
    rows = {name: _k8_check(rng, name, name in K8_TIMED) for name in K8_SHAPES}
    emit({"phase": "kernel_check", "kernel": "K8 frontier_filter", "shapes": rows})
    bad = [name for name, r in rows.items() if not r["bit_equal"] or r["launches"] != 1]
    if bad:
        raise SystemExit(f"K8 differs from frontier_filter_ref (or did not launch once) at {bad}")
    serve = rows["bq_serve"]
    torch.cuda.empty_cache()
    return {"name": "frontier_filter", "route": "cuda", "source": "jvector_tpu_torch/csrc/frontier.cu",
            "replaces": "jvector_tpu/graph/searcher.py:99 (jnp, no Pallas kernel)", "max_abs_err": 0,
            "ms": serve["ms"], "plain_ms": serve["plain_ms"], "bound_ms": max(serve["bound_ms"],
                                                                           serve["compare_bound_ms"]),
            "bound_by": "compares" if serve["compare_bound_ms"] > serve["bound_ms"] else "bytes",
            "library_ms": None, "device_us": serve["device_us"], "host_us": serve["host_us"], "shapes": rows}


def _k5_inputs(gen: torch.Generator, q: int, c: int, m: int, k: int):
    dev = torch.device("cuda")
    luts = torch.rand((q, m, k), generator=gen, device=dev) * 50.0
    codes = torch.randint(0, k, (q, c, m), generator=gen, device=dev, dtype=torch.uint8)
    return luts, codes


def _k5_bytes(luts: torch.Tensor, codes: torch.Tensor) -> int:
    """K5's least traffic: each distinct table read once (one for a shared
    table), the codes read once, the scores written once."""
    tables = 1 if luts.stride(0) == 0 else luts.shape[0]
    return tables * luts[0].numel() * 4 + codes.numel() + codes.shape[0] * codes.shape[1] * 4


def _k5_check(gen, q, c, m, k, flush: torch.Tensor, timed: bool) -> dict:
    """K5 at one shape: bit-equal to ``adc_score_ordered`` (its order) and
    within float32 rounding of ``adc_score`` (the CPU paths' twin), the
    wrapper's launch plan, and where ``timed`` the event ms of the wrapper,
    the ordered twin and the library call, and :func:`cold_warm_us` of the
    kernel with its share of the byte bound from each device time."""
    from jvector_tpu_torch.ops.adc import adc_score, adc_score_ordered
    from jvector_tpu_torch.ops.kernels.adc import adc_score_kernel, plan_for

    luts, codes = _k5_inputs(gen, q, c, m, k)
    got = adc_score_kernel(luts, codes)
    want = adc_score_ordered(luts, codes)
    torch.cuda.synchronize()
    row = {"shape": {"Q": q, "C": c, "M": m, "K": k}, "plan": plan_for(luts, codes)._asdict(),
           "bit_equal": bool(torch.equal(got, want)), "max_abs_err": float((got - want).abs().max()),
           "max_abs_err_vs_adc_score": float((got - adc_score(luts, codes)).abs().max()),
           "bytes": _k5_bytes(luts, codes)}
    row["bound_ms"] = bound_ms(row["bytes"])
    if timed:
        row["ms"] = median_ms(lambda: adc_score_kernel(luts, codes))
        row["plain_ms"] = median_ms(lambda: adc_score_ordered(luts, codes))
        row["library_ms"] = median_ms(lambda: _k5_library(luts, codes))
        row.update(cold_warm_us(lambda: adc_score_kernel(luts, codes), "adc_ring_kernel", flush))
        for key in ("cold", "clean_cold", "warm"):
            dev_us = row[f"device_{key}_us"]
            row[f"share_of_bound_{key}"] = row["bound_ms"] * 1e3 / dev_us if dev_us else None
    return row


def _k5_library(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """The same function in PyTorch calls: one gather, summed over M."""
    return torch.gather(luts, 2, codes.transpose(1, 2).long()).sum(1)


# K5 shapes: the serve and build-search shapes this path gives the kernel
# (R = 56 adjacency slots of the PQ-built base layer, E = 2 expansions per
# build step, 64 slots on the SQ4-built upper levels), the refine's beam
# step and the rescore's score_nodes (a chunk of 1024 rows, one expansion of
# R = 56 slots, or a row's 56 neighbors, each), the intra-wave and
# centroid-scan calls, the lifecycle's PQ-sidecar compaction at 20k
# (256-query waves: the in-source beam step, two expansions of R = 32; the
# merged-space scores of a source row's 32 neighbors; each search's entry
# score; the 1 x 20,000 centroid scan), and an unaligned shape (M not a
# multiple of 16, K < 256)
K5_SHAPES = {
    "serve": (4096, 56, 16, 256),
    "serve_fused_levels": (4096, 64, 16, 256),
    "build_search": (512, 112, 16, 256),
    "build_intra_wave": (512, 512, 16, 256),
    "refine_search_rescore": (1024, 56, 16, 256),
    "baseline_config3_serve": (1024, 64, 24, 256),  # anisotropic PQ, m = 24 on d = 96, 1024-query waves, 64 slots
    "centroid_scan": (1, 1_000_000, 16, 256),
    "compaction_beam_step": (256, 64, 16, 256),
    "compaction_candidates": (256, 32, 16, 256),
    "compaction_entry": (256, 1, 16, 256),
    "compaction_centroid_scan": (1, 20_000, 16, 256),
    "unaligned": (13, 19, 5, 32),
}


# K6 shapes (Q, MP, C, shared table), as the paths launch them
# (``k6_launches_by_shape`` of the LUT16 serves): the flagship 128-d serve
# (MP = 32, one expansion of R = 64 slots) in its 4096-query QPS waves and
# its 1024-query recall waves, and each wave's entry score (C = 1); the
# same for the mips-96d serve (MP = 24; its names keep the 1M corpus the
# shape was first measured at); the micro's lut16_adc_score (256 queries
# x 64 candidates); the cosine norm (one table of squared centroid norms,
# query stride 0) and an unaligned shape
K6_SHAPES = {
    "serve_200k": (4096, 32, 64, False),
    "serve_200k_recall": (1024, 32, 64, False),
    "serve_200k_entry": (4096, 32, 1, False),
    "serve_200k_recall_entry": (1024, 32, 1, False),
    "serve_mips_1m": (4096, 24, 64, False),
    "serve_mips_recall": (1024, 24, 64, False),
    "serve_mips_entry": (4096, 24, 1, False),
    "serve_mips_recall_entry": (1024, 24, 1, False),
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
    """K6's traffic with whole tables: each distinct table read once (one
    for a shared table), the codes read once, the scores written once."""
    tables = 1 if luts.stride(0) == 0 else luts.shape[0]
    return tables * luts[0].numel() * 4 + codes.numel() + codes.shape[0] * codes.shape[2] * 4


def _k6_sector_bytes(luts: torch.Tensor, codes: torch.Tensor) -> int:
    """K6's least traffic for these codes, in the 32-byte sectors that HBM
    moves: of each distinct table, the sectors that the codes' gathers
    touch (a row's 32 entries are four sectors: low nibbles 0-7 and 8-15,
    high nibbles 0-7 and 8-15), each read once; the codes read once, the
    scores written once.  With few candidates a query (the entry scores)
    the gathers touch about half of each table; at C = 64 all of it."""
    q, mp, c = codes.shape
    touched = torch.zeros((q, mp, 4), dtype=torch.bool, device=codes.device)
    touched.scatter_(2, ((codes & 15) >> 3).long(), True)
    touched.scatter_(2, (2 + (codes >> 7)).long(), True)
    if q > 1 and luts.stride(0) == 0:
        touched = touched.any(0)
    return int(touched.sum()) * 32 + codes.numel() + q * c * 4


def _k6_library(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """The same function in PyTorch calls: a gather per nibble, summed over MP."""
    return (torch.gather(luts[..., :16], 2, (codes & 15).long())
            + torch.gather(luts[..., 16:], 2, (codes >> 4).long())).sum(1)


def _k6_check(gen, q, mp, c, shared, timed: bool) -> dict:
    """K6 at one shape: bit-equal to ``adc16_ordered`` (the Pallas order)
    and within float32 rounding of ``adc16_ref`` (the CPU paths' twin),
    the wrapper's launch plan, the sector bound (:func:`_k6_sector_bytes`)
    beside the whole-table one, and where ``timed`` the event ms of the
    wrapper, of ``adc16_ref`` (the plain version) and of the library call,
    the kernel's device us (back to back) and host us a wrapper call, and
    its share of the sector bound."""
    from jvector_tpu_torch.ops.adc16 import adc16_ordered, adc16_ref
    from jvector_tpu_torch.ops.kernels.adc16 import adc16_score_kernel, plan_for

    luts, codes = _k6_inputs(gen, q, mp, c, shared)
    got = adc16_score_kernel(luts, codes)
    want, ref = adc16_ordered(luts, codes), adc16_ref(luts, codes)
    torch.cuda.synchronize()
    row = {"shape": {"Q": q, "MP": mp, "C": c, "shared_table": shared}, "plan": plan_for(luts, codes)._asdict(),
           "bit_equal": bool(torch.equal(got, want)), "max_abs_err": float((got - want).abs().max()),
           "allclose_vs_adc16_ref": bool(torch.allclose(got, ref, rtol=1e-5, atol=1e-4)),
           "max_abs_err_vs_adc16_ref": float((got - ref).abs().max()),
           "bound_ms": bound_ms(_k6_sector_bytes(luts, codes)), "table_bound_ms": bound_ms(_k6_bytes(luts, codes))}
    if timed:
        row["ms"] = median_ms(lambda: adc16_score_kernel(luts, codes))
        row["plain_ms"] = median_ms(lambda: adc16_ref(luts, codes))
        row["library_ms"] = median_ms(lambda: _k6_library(luts, codes))
        row["device_us"] = device_us(lambda: adc16_score_kernel(luts, codes))["device_us"]
        row["host_us"] = host_us(lambda: adc16_score_kernel(luts, codes))
        row["share_of_bound"] = row["bound_ms"] * 1e3 / row["device_us"] if row["device_us"] else None
    return row


def _apply_times(call, floor_us) -> dict:
    """K1's, K2's and K3's timing fields beside the event ``ms``: device us
    per call from back-to-back calls, the kernels each call launched, the
    host us per wrapper call, and the launch floor.  A window whose counts
    are not whole numbers a call lost events in the profiler (a call
    launches whole kernels), so it is taken again, at most twice."""
    for _ in range(3):
        dev = device_us(call)
        per_call = dev["kernels_per_call"]
        if per_call is None or all(float(c).is_integer() for c in per_call.values()):
            break
    if per_call is not None and list(per_call.values()) != [1.0]:
        raise SystemExit(f"a build-apply call launched {per_call} kernels, not one")
    return {"device_us": dev["device_us"], "kernels_per_call": per_call,
            "host_us": host_us(call), "launch_floor_us": floor_us}


def _k2_check(rng: np.random.Generator, dev, floor_us, **shape) -> dict:
    """K2 against its twin on :func:`_k2_inputs` (``shape``: its table
    arguments), bit-exact or the script fails; the timing fields of the
    kernels line."""
    from jvector_tpu_torch.ops.kernels.scatter_rows import fused_update_inplace, fused_update_ref

    table, args = _k2_inputs(rng, dev, **shape)
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
    times = _apply_times(lambda: fused_update_inplace(kt, *args), floor_us)
    n_bytes = _k2_bytes(table, args)
    emit({"phase": "kernel_check", "kernel": "K2 fused_update_inplace", "table": list(table.shape),
          "bit_exact": exact, "rows_changed": changed, "ms": ms, "plain_ms": plain_ms, **times, "bytes": n_bytes})
    if not exact or changed == 0:
        raise SystemExit(f"K2 disagrees with its twin on a {list(table.shape)} table")
    del table, kt, rt, args
    torch.cuda.empty_cache()
    return {"table": shape or {"n_cap": 1_048_576, "t3": 32, "mp": 64}, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms(n_bytes), "bound_by": "bytes", "library_ms": None, **times}


def phase_kernel_check() -> list[dict]:
    from jvector_tpu_torch.ops.kernels.packed_adj import (
        packed_adj_only_update_inplace,
        packed_adj_only_update_ref,
        packed_adj_update_inplace,
        packed_adj_update_ref,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(1234)
    out = []
    floor_us = launch_floor_us()
    emit({"phase": "kernel_check", "kernel": "launch floor", "device_us": floor_us})

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
    times = _apply_times(lambda: packed_adj_update_inplace(ka, kw, *args), floor_us)
    n_bytes = _k1_bytes(adj, args)
    emit({"phase": "kernel_check", "kernel": "K1 packed_adj_update_inplace", "bit_exact": exact,
          "physical_rows_changed": changed, "ms": ms, "plain_ms": plain_ms, **times, "bytes": n_bytes})
    if not exact or changed == 0:
        raise SystemExit("K1 disagrees with its twin")
    out.append({"name": "packed_adj_update_inplace", "route": "cuda",
                "source": "jvector_tpu_torch/csrc/packed_adj.cu",
                "replaces": "jvector_tpu/ops/pallas/packed_adj.py:364",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms(n_bytes), "bound_by": "bytes", "library_ms": None, **times})
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
    times = _apply_times(lambda: packed_adj_only_update_inplace(ka, *args), floor_us)
    n_bytes = _k3_bytes(adj, args)
    emit({"phase": "kernel_check", "kernel": "K3 packed_adj_only_update_inplace", "bit_exact": exact,
          "physical_rows_changed": changed, "ms": ms, "plain_ms": plain_ms, **times, "bytes": n_bytes})
    if not exact or changed == 0:
        raise SystemExit("K3 disagrees with its twin")
    out.append({"name": "packed_adj_only_update_inplace", "route": "cuda",
                "source": "jvector_tpu_torch/csrc/packed_adj.cu",
                "replaces": "jvector_tpu/ops/pallas/packed_adj.py:501",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms(n_bytes), "bound_by": "bytes", "library_ms": None, **times})
    del adj, ka, ra, args

    k2 = _k2_check(rng, dev, floor_us)
    # BASELINE config 4's table: 212,992 rows of 43,008 bytes (MP = 768)
    k2_wide = _k2_check(rng, dev, floor_us, n_cap=212_992, t3=336, mp=768)
    out.append({"name": "fused_update_inplace", "route": "cuda",
                "source": "jvector_tpu_torch/csrc/fused_update.cu",
                "replaces": "jvector_tpu/ops/pallas/scatter_rows.py:426",
                "max_abs_err": max(k2["max_abs_err"], k2_wide["max_abs_err"]),
                **{k: v for k, v in k2.items() if k != "max_abs_err"}, "baseline_config4_row": k2_wide})

    gen = torch.Generator(device=dev).manual_seed(1234)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rows = {name: _k5_check(gen, *shape, flush=flush, timed=name != "unaligned")
            for name, shape in K5_SHAPES.items()}
    del flush
    for name, r in rows.items():  # the launch plan of each shape, as the wrapper's planner chose it
        print(f"K5 plan {name} {r['shape']}: {r['plan']}", flush=True)
    emit({"phase": "kernel_check", "kernel": "K5 adc_score_kernel", "shapes": rows})
    bad = [name for name, r in rows.items() if not r["bit_equal"]]
    if bad:
        raise SystemExit(f"K5 differs from adc_score_ordered at {bad}")
    serve = rows["serve"]
    out.append({"name": "adc_score_kernel", "route": "cuda",
                "source": "jvector_tpu_torch/csrc/adc.cu",
                "replaces": "jvector_tpu/ops/pallas/adc_kernel.py:63",
                "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
                "ms": serve["ms"], "plain_ms": serve["plain_ms"], "bound_ms": serve["bound_ms"],
                "bound_by": "bytes", "library_ms": serve["library_ms"],
                "shapes": {name: {k: v for k, v in r.items() if k not in ("plan", "bytes")}
                           for name, r in rows.items()}})

    rows = {name: _k6_check(gen, *shape, timed=name != "unaligned") for name, shape in K6_SHAPES.items()}
    for name, r in rows.items():  # the launch plan of each shape, as the wrapper's planner chose it
        print(f"K6 plan {name} {r['shape']}: {r['plan']}", flush=True)
    emit({"phase": "kernel_check", "kernel": "K6 adc16_score_kernel", "shapes": rows})
    bad = [name for name, r in rows.items() if not (r["bit_equal"] and r["allclose_vs_adc16_ref"])]
    if bad:
        raise SystemExit(f"K6 differs from adc16_ordered (or from adc16_ref beyond rounding) at {bad}")
    serve = rows["serve_200k"]
    out.append({"name": "adc16_score_kernel", "route": "cuda",
                "source": "jvector_tpu_torch/csrc/adc16.cu",
                "replaces": "jvector_tpu/ops/pallas/adc16_kernel.py:109",
                "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
                "ms": serve["ms"], "plain_ms": serve["plain_ms"], "bound_ms": serve["bound_ms"],
                "bound_by": "bytes", "library_ms": serve["library_ms"], "device_us": serve["device_us"],
                "host_us": serve["host_us"],
                "shapes": {name: {k: v for k, v in r.items() if k != "plan"} for name, r in rows.items()}})
    torch.cuda.empty_cache()
    out.append(phase_frontier_check(rng))
    return out


def _counters() -> dict:
    from jvector_tpu_torch.ops.kernels import (
        adc16_score_kernel,
        adc_score_kernel,
        frontier_filter,
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
            "adc16_score_kernel": adc16_score_kernel,
            "frontier_filter": frontier_filter}


def reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0
    _counters()["adc_score_kernel"].by_shape.clear()
    _counters()["adc16_score_kernel"].by_shape.clear()


def read_k5_shapes() -> dict:
    """K5's launches since the last :func:`reset_counts` by shape, ``"QxCxM"``."""
    return {"x".join(map(str, shape)): n
            for shape, n in sorted(_counters()["adc_score_kernel"].by_shape.items(), key=lambda kv: -kv[1])}


def read_k6_shapes(what: str) -> dict:
    """K6's launches since the last :func:`reset_counts` by shape,
    ``"QxMPxC"``; fails if ``what`` launched K6 at a shape that no
    ``K6_SHAPES`` entry (shared table or not) holds bit-equal."""
    shapes = {"x".join(map(str, shape)): n
              for shape, n in sorted(_counters()["adc16_score_kernel"].by_shape.items(), key=lambda kv: -kv[1])}
    checked = {"x".join(map(str, shape[:3])) for shape in K6_SHAPES.values()}
    if shapes.keys() - checked:
        raise SystemExit(f"{what} launched K6 at shapes no K6_SHAPES entry checks: {shapes}")
    return shapes


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


def _timed(fn):
    """``fn()`` and its seconds on the host clock, the device synced."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def _exact_topk(base: torch.Tensor, queries: torch.Tensor, k: int, mask: torch.Tensor | None = None) -> np.ndarray:
    """Exact euclidean top-k ids on the card: one float32 matmul over the
    corpus, the columns outside ``mask`` excluded."""
    d = (base * base).sum(dim=1)[None, :] - 2.0 * queries @ base.T
    if mask is not None:
        d = d.masked_fill(~mask[None, :], float("inf"))
    return torch.topk(d, k, dim=1, largest=False).indices.cpu().numpy()


def _repeats(first: torch.Tensor, second: torch.Tensor) -> int:
    """Ids of ``second`` that ``first`` already returned (per query)."""
    return int(((first[:, :, None] == second[:, None, :]) & (second[:, None, :] >= 0)).any(dim=1).sum())


def _accept_mask(rng: np.random.Generator, n: int, selectivity: float) -> np.ndarray:
    mask = np.zeros(n, bool)
    mask[rng.choice(n, int(round(n * selectivity)), replace=False)] = True
    return mask


def _search_api_sq4(graph, exact, sq4, base: torch.Tensor, queries: torch.Tensor, gt: np.ndarray,
                    dev: torch.device) -> tuple[dict, list]:
    """The search API on the SQ4 200k graph (SQ4 first pass + exact rerank
    at beam 100 unless said otherwise): filtered search at each of
    :data:`SELECTIVITIES`, threshold search (exact first pass), resume
    with and without the state, and multi-index search over
    :data:`MULTI_SHARDS` SQ4 shards built from the same corpus.  Ground
    truth is exact, on the card; recall over the first 1024 queries,
    seconds over one 4096-query wave.  Returns the line and the failures."""
    from jvector_tpu_torch.graph import resume, search
    from jvector_tpu_torch.util.datasets import recall_at_k

    n = base.shape[0]
    q_gt, wave = queries[:GT_QUERIES], queries[:WAVE]
    kw = dict(top_k=TOP_K, beam_width=API_BEAM, rerank_k=API_BEAM, reranker=exact)
    line, fails = {"phase": "search_api", "graph": "sq4_path", "n": n, "dim": base.shape[1], "beam_width": API_BEAM,
                   "filter_expand_per_iter": FILTER_EXPAND}, []

    rng = np.random.default_rng(0)
    line["filtered"] = {}
    # four pops a step: a 1% filter on 200k nodes needs a few thousand pops
    # to fill its accepted channel (rerank_k = 100), past 1000 single-pop steps
    fkw = dict(kw, expand_per_iter=FILTER_EXPAND)
    for sel in SELECTIVITIES:
        m_np = _accept_mask(rng, n, sel)
        mask = torch.as_tensor(m_np, device=dev)
        fgt = _exact_topk(base, q_gt, TOP_K, mask)
        reset_counts()
        res, secs_gt = _timed(lambda: search(graph, sq4, q_gt, accept=mask, **fkw))
        _, secs = _timed(lambda: search(graph, sq4, wave, accept=mask, **fkw))
        ids = res.ids.cpu().numpy()
        row = {"accepted": int(m_np.sum()), "path": "brute" if int(res.expanded_count.sum()) == 0 else "graph",
               "recall": recall_at_k(ids, fgt, TOP_K), "holes": int((ids < 0).sum()),
               "not_accepted": int((~m_np[np.maximum(ids, 0)] & (ids >= 0)).sum()),
               "expanded_mean": float(res.expanded_count.float().mean()), "seconds_1024": secs_gt,
               "seconds_4096": secs, "launches": read_counts()}
        line["filtered"][str(sel)] = row
        if row["holes"] or row["not_accepted"]:
            fails.append(f"filtered {sel}: {row['holes']} holes, {row['not_accepted']} ids not accepted")
        if sel >= 0.01 and row["recall"] < FILTER_FLOOR:
            fails.append(f"filtered {sel}: recall@10 {row['recall']} < {FILTER_FLOOR}")
        if row["accepted"] <= max(4 * API_BEAM, 512) and row["path"] != "brute":
            fails.append(f"filtered {sel}: {row['accepted']} accepted nodes did not take the brute path")

    # threshold: the median over the queries of the exact 10th-best score
    gt_t = torch.as_tensor(gt[:, :TOP_K], device=dev)
    gt_scores = exact.score(exact.prepare(q_gt), gt_t)
    thr = float(torch.median(gt_scores[:, -1]))
    free, s_free = _timed(lambda: search(graph, exact, q_gt, top_k=TOP_K, beam_width=API_BEAM))
    got, s_thr = _timed(lambda: search(graph, exact, q_gt, top_k=TOP_K, beam_width=API_BEAM, threshold=thr))
    above = gt_scores >= thr
    kept = ((gt_t[:, :, None] == got.ids[:, None, :]).any(dim=2) & above).sum()
    _, w_free = _timed(lambda: search(graph, exact, wave, top_k=TOP_K, beam_width=API_BEAM))
    _, w_thr = _timed(lambda: search(graph, exact, wave, top_k=TOP_K, beam_width=API_BEAM, threshold=thr))
    below = int((got.scores < thr)[got.ids >= 0].sum())
    line["threshold"] = {
        "first_pass": "exact", "threshold": thr, "results": int((got.ids >= 0).sum()), "below_threshold": below,
        "retention": float(kept) / max(1, int(above.sum())),
        "expansions_saved": 1.0 - float(got.expanded_count.sum()) / float(free.expanded_count.sum()),
        "seconds_4096": w_thr, "seconds_4096_unthresholded": w_free,
    }
    if below:
        fails.append(f"threshold: {below} results score below {thr}")

    # resume: page 2 with and without the beam state; exact ranks 11-20
    gt20 = _exact_topk(base, q_gt, 2 * TOP_K)[:, TOP_K:]
    reset_counts()
    page1, state = search(graph, sq4, q_gt, return_state=True, **kw)
    with_state = resume(graph, sq4, q_gt, page1, top_k=TOP_K, reranker=exact, state=state)
    without = resume(graph, sq4, q_gt, page1, top_k=TOP_K, reranker=exact)
    line["resume"] = {
        "recall_ranks_11_20": {"with_state": recall_at_k(with_state.ids.cpu().numpy(), gt20, TOP_K),
                               "without_state": recall_at_k(without.ids.cpu().numpy(), gt20, TOP_K)},
        "repeated_ids": {"with_state": _repeats(page1.ids, with_state.ids),
                         "without_state": _repeats(page1.ids, without.ids)},
        "marginal_expansions_mean": {
            "with_state": float((with_state.expanded_count - page1.expanded_count).float().mean()),
            "without_state": float(without.expanded_count.float().mean())},
        "page1_expansions_mean": float(page1.expanded_count.float().mean()),
    }
    if any(line["resume"]["repeated_ids"].values()):
        fails.append(f"resume repeated page-1 ids: {line['resume']['repeated_ids']}")
    del state
    line["multi_index"] = _multi_index(base, q_gt, wave, fails)
    return line, fails


def _multi_index(base: torch.Tensor, q_gt: torch.Tensor, wave: torch.Tensor, fails: list) -> dict:
    """:data:`MULTI_SHARDS` SQ4 shards of equal size built from the corpus's
    first :data:`MULTI_N` vectors (``build_graph`` at the flagship config,
    SQ4 first pass, exact rerank), merged by ``multi_search``: the stacked
    path (one wave over the shards' tables laid end to end) and the
    sequential one with and without ``rerank_floor``; recall against the
    exact top-10 over the vectors the shards index."""
    from jvector_tpu_torch.graph import GraphConfig, build_graph
    from jvector_tpu_torch.graph.multi import IndexShard, _can_stack, multi_search
    from jvector_tpu_torch.quantization import ScalarQuantization4
    from jvector_tpu_torch.util.datasets import recall_at_k

    base = base[:MULTI_N]
    gt = _exact_topk(base, q_gt, TOP_K)
    per = base.shape[0] // MULTI_SHARDS
    reset_counts()
    shards, t0 = [], time.time()
    for s in range(MULTI_SHARDS):
        part = base[s * per : (s + 1) * per]
        g, ex = build_graph(part, "euclidean", GraphConfig(max_degree=32, ef_construction=100))
        sq = ScalarQuantization4.compute(part)
        codes = torch.nn.functional.pad(sq.encode(part), (0, 0, 0, g.capacity - per))
        shards.append(IndexShard(graph=g, provider=sq.provider_for_graph(codes, g.base.neighbors, "euclidean"),
                                 reranker=ex, id_offset=s * per))
    torch.cuda.synchronize()
    row = {"shards": MULTI_SHARDS, "shard_n": per, "n": base.shape[0], "build_seconds": time.time() - t0,
           "build_launches": read_counts(),
           "stackable": _can_stack(shards)}
    kw = dict(top_k=TOP_K, beam_width=API_BEAM, rerank_k=API_BEAM)
    runs = {"stacked": dict(stacked=True), "sequential": dict(stacked=False),
            "sequential_no_floor": dict(stacked=False, use_rerank_floor=False)}
    for name, extra in runs.items():
        res = multi_search(shards, q_gt, **kw, **extra)
        _, secs = _timed(lambda: multi_search(shards, wave, **kw, **extra))
        row[name] = {"recall": recall_at_k(res.ids.cpu().numpy(), gt, TOP_K), "seconds_4096": secs,
                     "reranked_mean": float(res.reranked_count.float().mean()),
                     "expanded_mean": float(res.expanded_count.float().mean())}
    row["reranks_saved_by_floor"] = 1.0 - row["sequential"]["reranked_mean"] / row["sequential_no_floor"]["reranked_mean"]
    for name in ("stacked", "sequential"):
        if row[name]["recall"] < FILTER_FLOOR:
            fails.append(f"multi-index {name}: recall@10 {row[name]['recall']} < {FILTER_FLOOR}")
    if not row["stackable"]:
        fails.append("the multi-index shards did not stack")
    del shards
    torch.cuda.empty_cache()
    return row


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
    row["k6_launches_by_shape"] = read_k6_shapes("the LUT16 serve")
    del prov, fused, packed
    torch.cuda.empty_cache()
    return row


@contextlib.contextmanager
def _real_wave_check(wave: int):
    """Hold K1 and K2 to their twins on one real wave of the next packed
    build: wraps ``builder._wave_apply_packed`` so that call ``wave`` (from
    1) clones the three tables first, applies the wave through the kernels
    (the build's own launches), applies it again to the clones through the
    twins, and records bit equality, the streams' hazards (appends and
    enforce images on wave rows, K2's drop markers) and the kernels' device
    time on those streams.  The timing launches are taken back out of the
    launch counts.  Yields the record, filled once the wave has run."""
    from jvector_tpu_torch.graph import builder
    from jvector_tpu_torch.ops.kernels import packed_adj as kpa
    from jvector_tpu_torch.ops.kernels import scatter_rows as ksr

    apply, record, calls = builder._wave_apply_packed, {}, [0]

    @contextlib.contextmanager
    def applying(k1, k2):  # what _wave_apply_packed calls for K1 and K2
        builder.packed_adj_update_inplace, builder.fused_update_inplace = k1, k2
        try:
            yield
        finally:
            builder.packed_adj_update_inplace = kpa.packed_adj_update_inplace
            builder.fused_update_inplace = ksr.fused_update_inplace

    def checked(adj, w2t, fused, adj_stream, fused_stream):
        calls[0] += 1
        if calls[0] != wave:
            return apply(adj, w2t, fused, adj_stream, fused_stream)
        ra, rw, rf = adj.clone(), w2t.clone(), fused.clone()
        apply(adj, w2t, fused, adj_stream, fused_stream)
        args = {}

        def k1_twin(*a):
            args["k1"] = a
            return kpa.packed_adj_update_ref(*a)

        def k2_twin(*a):
            args["k2"] = a
            return ksr.fused_update_ref(*a)

        with applying(k1_twin, k2_twin):
            apply(ra, rw, rf, adj_stream, fused_stream)
        torch.cuda.synchronize()
        n_pr, n = adj.shape[0], fused.shape[0]
        a_rows, m_key, m_img = adj_stream[0], adj_stream[3], adj_stream[8]
        prow = torch.where(m_key < n_pr * 8, m_key >> 3, -1)
        on_wave = torch.isin(prow, a_rows) & (prow >= 0)
        f_rows, f_p_rows = fused_stream[0], fused_stream[2]
        live = (f_p_rows >= 0) & (f_p_rows < n)
        last_live = int(torch.nonzero(live).max()) if bool(live.any()) else -1
        record.update({
            "wave": wave, "k1_bit_exact": torch.equal(adj, ra) and torch.equal(w2t, rw),
            "k2_bit_exact": torch.equal(fused, rf),
            "k1_patches": int((prow >= 0).sum()), "k1_appends_on_wave_rows": int((on_wave & (m_img < 0)).sum()),
            "k1_enforce_images_on_wave_rows": int((on_wave & (m_img >= 0)).sum()),
            "k2_patches": int(live.sum()),
            "k2_patches_on_wave_rows": int((torch.isin(f_p_rows, f_rows) & live).sum()),
            "k2_minus_one_inside": int((f_p_rows[: last_live + 1] < 0).sum()),
            "k2_drop_tail": int((f_p_rows >= n).sum()),
        })
        # the kernels' device time on these streams, re-applied to the twins'
        # tables (which already hold the wave); these launches do not count
        saved = kpa.packed_adj_update_inplace.launches, ksr.fused_update_inplace.launches
        record["k1_device_us"] = device_us(lambda: kpa.packed_adj_update_inplace(*args["k1"]))["device_us"]
        record["k2_device_us"] = device_us(lambda: ksr.fused_update_inplace(*args["k2"]))["device_us"]
        kpa.packed_adj_update_inplace.launches, ksr.fused_update_inplace.launches = saved

    builder._wave_apply_packed = checked
    try:
        yield record
    finally:
        builder._wave_apply_packed = apply


def _digest(graph) -> str:
    """sha256 over every table of a graph (a checksum for "unchanged")."""
    import hashlib

    h = hashlib.sha256()
    for t in [*(t for layer in graph.layers for t in layer), *graph.level_node_ids, graph.deleted,
              graph.entry_node, graph.num_nodes]:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _sq4_plain(sq, vectors: torch.Tensor):
    """An SQ4 first pass that reads code rows only (no fused tables), so it
    serves any graph over ``vectors``."""
    from jvector_tpu_torch.graph.score import SQ4ScoreProvider, sq4_aug_rows

    codes = sq.encode(vectors)
    w2, norm2 = sq.node_constants(codes)
    empty = torch.zeros((1, 0), device=vectors.device)
    return SQ4ScoreProvider(codes_packed=codes, node_w2=w2, node_norm2=norm2, fused_packed=empty.to(torch.uint8),
                            fused_w2=empty, scale=sq.scale, offset=sq.offset, codes_aug=sq4_aug_rows(codes, w2))


def _carried_codebooks(rows: np.ndarray, m: int = 16, k: int = 256, seed: int = LIFECYCLE_SEED) -> np.ndarray:
    """``[m, k, d/m]`` PQ codebooks drawn from ``rows`` without training, as
    ``experiments/torch_lifecycle_cpu.py`` draws them for the JAX package:
    the centroids of subspace i are k distinct rows' i-th slices."""
    rng = np.random.default_rng(seed)
    s = rows.shape[1] // m
    return np.stack([rows[rng.choice(len(rows), k, replace=False), i * s : (i + 1) * s] for i in range(m)])


def _lifecycle_pq_compaction(dev: torch.device) -> dict:
    """``compact_indexes(pq=...)`` at 20k: three uneven segments built by
    the port; every graph score on codes (K5).  Run twice: with the sidecar
    retrain of a base PQ (m = 16, K = 256) trained on the first segment
    (the path's main run), and with ``retrain=False`` on codebooks drawn
    alike by both packages (:func:`_carried_codebooks`).  Each run's K5
    launches, by shape too, and recall@10 with exact rerank."""
    from jvector_tpu_torch import convert
    from jvector_tpu_torch.disk import CompactionSource, compact_indexes
    from jvector_tpu_torch.graph import ExactScoreProvider, GraphConfig, build_graph, search
    from jvector_tpu_torch.quantization import ProductQuantization
    from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset

    cfg = GraphConfig(max_degree=32, ef_construction=100)
    n = LIFECYCLE_PQ_SPLITS[-1][1]
    ds = synthetic_dataset(n=n, dim=128, n_queries=GT_QUERIES, k=TOP_K, n_clusters=64, seed=0, device=dev)
    t0 = time.time()
    sources = [CompactionSource(graph=build_graph(torch.as_tensor(ds.base[a:b], device=dev), "euclidean", cfg)[0],
                                vectors=ds.base[a:b]) for a, b in LIFECYCLE_PQ_SPLITS]
    base_pq = ProductQuantization.compute(ds.base[: LIFECYCLE_PQ_SPLITS[0][1]], m=16, clusters=256, device=dev)
    carried_pq = convert.pq_from_numpy(_carried_codebooks(ds.base[: LIFECYCLE_PQ_SPLITS[0][1]]), None, 128,
                                       device=dev)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    queries = torch.as_tensor(ds.queries, device=dev)

    def run(pq, retrain: bool) -> dict:
        reset_counts()
        (merged, prov, mappers), secs = _timed(lambda: compact_indexes(sources, cfg, "euclidean", pq=pq,
                                                                       retrain=retrain))
        launches, shapes = read_counts(), read_k5_shapes()
        new_of_old = np.concatenate(mappers)
        merged_vecs = np.empty_like(ds.base)
        merged_vecs[new_of_old] = ds.base
        exact = ExactScoreProvider(vectors=torch.as_tensor(merged_vecs, device=dev))
        gt = new_of_old[ds.ground_truth[:, :TOP_K]]
        recall = {b: recall_at_k(_check_result(search(merged, prov, queries, top_k=TOP_K, beam_width=b, rerank_k=b,
                                                      reranker=exact), GT_QUERIES, f"PQ compaction at beam {b}"),
                                 gt, TOP_K) for b in (50, 100)}
        return {"compact_seconds": secs, "recall": recall, "launches": launches, "k5_launches_by_shape": shapes}

    retrained = run(base_pq, True)
    carried = run(carried_pq, False)
    return {"n": n, "splits": LIFECYCLE_PQ_SPLITS, "segment_build_seconds": build_s, **retrained,
            "jax_recall_by_seed": JAX_PQ_COMPACTION_RECALL_20K, "carried": carried,
            "jax_carried_recall": JAX_PQ_CARRIED_RECALL_20K}


def _lifecycle(graph, exact, sq, base: torch.Tensor, queries: torch.Tensor, gt: np.ndarray, beams: list,
               dev: torch.device) -> dict:
    """The index lifecycle on the SQ4 path's graph (see LIFECYCLE_*): each
    step's seconds and checks; fails after printing its line."""
    import tempfile

    from jvector_tpu_torch.disk import DeviceTierIndex, compact_on_disk, write_index
    from jvector_tpu_torch.graph import GraphConfig, search
    from jvector_tpu_torch.graph.mutation import add_nodes, mark_deleted, remove_deleted
    from jvector_tpu_torch.graph.nndescent import nn_descent_build
    from jvector_tpu_torch.quantization import ProductQuantization
    from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset

    t_phase = time.time()
    torch.cuda.reset_peak_memory_stats()
    cfg = GraphConfig(max_degree=32, ef_construction=100)
    n = base.shape[0]
    n_del = n // 10
    deleted = np.sort(np.random.default_rng(LIFECYCLE_SEED).choice(n, n_del, replace=False))
    live = np.ones(n, bool)
    live[deleted] = False
    q_gt = queries[:GT_QUERIES]
    gt_live = _exact_topk(base, q_gt, TOP_K, torch.as_tensor(live, device=dev))
    first = _sq4_plain(sq, exact.vectors)
    fails, steps = [], {}

    def run(g, prov, rerank, qs, beam):
        return search(g, prov, qs, top_k=TOP_K, beam_width=beam, rerank_k=beam, reranker=rerank,
                      repack_after=max(8, int(1.6 * beam)))

    def recall(g, prov, rerank, truth, beam=API_BEAM, id_map=None):
        ids = _check_result(run(g, prov, rerank, q_gt, beam), GT_QUERIES, f"lifecycle search at beam {beam}")
        return recall_at_k(ids if id_map is None else id_map[ids], truth, TOP_K), ids

    def step(name, fn):
        reset_counts()
        out, secs = _timed(fn)
        steps[name] = {"seconds": secs, "launches": {k: v for k, v in read_counts().items() if v}}
        return out

    before = _digest(graph)
    recall_full_before, _ = recall(graph, first, exact, gt)
    recall_full_before_low, _ = recall(graph, first, exact, gt, LIFECYCLE_LOW_BEAM)

    # 1. delete: tombstones only, the caller's graph untouched
    tomb = step("delete", lambda: mark_deleted(graph, deleted))
    recall_tomb, ids = recall(tomb, first, exact, gt_live)
    recall_tomb_low, _ = recall(tomb, first, exact, gt_live, LIFECYCLE_LOW_BEAM)
    hit = int(np.isin(ids, deleted).sum())
    steps["delete"].update(deleted=n_del, deleted_in_results=hit, recall_live=recall_tomb,
                           recall_live_low_beam=recall_tomb_low)
    if hit:
        fails.append(f"{hit} deleted ids in the results after mark_deleted")
    recall_full_after, _ = recall(graph, first, exact, gt)  # the pre-delete graph still serves
    steps["delete"].update(pre_delete_graph_recall=recall_full_after)
    if _digest(graph) != before or graph.deleted.any() or recall_full_after < RECALL_FLOOR:
        fails.append(f"mark_deleted changed the caller's graph (its recall@10 now {recall_full_after})")

    # 2. splice
    spliced = step("splice", lambda: remove_deleted(tomb, exact, cfg))
    nbrs = spliced.base.neighbors[:n]
    dead = torch.as_tensor(~live, device=dev)
    live_dev = ~dead
    dangling = int((dead[torch.clamp(nbrs, min=0).long()] & (nbrs >= 0)).sum())
    # a splice that only dropped the edges into deleted nodes would leave
    # each live row the tombstoned row's live edges; the 2-hop repair adds more
    t_nbrs = tomb.base.neighbors[:n]
    kept = (t_nbrs >= 0) & live_dev[torch.clamp(t_nbrs, min=0).long()]
    drop_only_degree = float(kept[live_dev].sum(1).float().mean())
    live_degree = float((nbrs >= 0)[live_dev].sum(1).float().mean())
    entry_live = bool(live[int(spliced.entry_node)])
    recall_splice, ids = recall(spliced, first, exact, gt_live)
    recall_splice_low, _ = recall(spliced, first, exact, gt_live, LIFECYCLE_LOW_BEAM)
    steps["splice"].update(dangling_edges=dangling, entry_live=entry_live, recall_live=recall_splice,
                           recall_live_before_splice=recall_tomb, recall_live_low_beam=recall_splice_low,
                           recall_live_low_beam_before_splice=recall_tomb_low, average_degree=spliced.average_degree(),
                           live_degree=live_degree, live_degree_drop_only=drop_only_degree)
    if dangling or not entry_live:
        fails.append(f"splice: {dangling} edges into deleted nodes, entry live {entry_live}")
    if live_degree <= drop_only_degree:
        fails.append(f"splice: live rows keep {live_degree} edges on average, no more than the "
                     f"{drop_only_degree} left by dropping the edges into deleted nodes")
    if recall_splice < RECALL_FLOOR or abs(recall_splice - recall_tomb) > LIFECYCLE_SPLICE_SLACK:
        fails.append(f"splice: recall@10 {recall_splice} (before the splice {recall_tomb})")
    if recall_splice_low < recall_tomb_low - LIFECYCLE_SPLICE_SLACK:
        fails.append(f"splice: recall@10 at beam {LIFECYCLE_LOW_BEAM} {recall_splice_low} (before the splice "
                     f"{recall_tomb_low})")

    # 3. insert the deleted vectors again as new ordinals
    spliced_digest = _digest(spliced)
    inserted, prov_ins = step("insert", lambda: add_nodes(spliced, exact, base[deleted], cfg))
    orig_of = np.concatenate([np.arange(n), deleted])
    first_ins = _sq4_plain(sq, prov_ins.vectors)
    recall_ins, _ = recall(inserted, first_ins, prov_ins, gt, id_map=orig_of)
    recall_ins_low, _ = recall(inserted, first_ins, prov_ins, gt, LIFECYCLE_LOW_BEAM, id_map=orig_of)
    unchanged = _digest(spliced) == spliced_digest
    steps["insert"].update(inserted=n_del, num_nodes=int(inserted.num_nodes), capacity=inserted.capacity,
                           recall=recall_ins, recall_low_beam=recall_ins_low, spliced_graph_unchanged=unchanged)
    if recall_ins < RECALL_FLOOR or not unchanged:
        fails.append(f"insert: recall@10 {recall_ins}, spliced graph unchanged {unchanged}")
    if recall_ins_low < recall_tomb_low - LIFECYCLE_SPLICE_SLACK:
        fails.append(f"insert: recall@10 at beam {LIFECYCLE_LOW_BEAM} {recall_ins_low} (the tombstoned graph's "
                     f"{recall_tomb_low})")
    del first_ins, inserted, prov_ins

    # 4. NN-descent over the same vectors
    seg = base[deleted]
    nnd, nnd_prov = step("nndescent", lambda: nn_descent_build(seg, "euclidean", cfg))
    gt_seg = _exact_topk(seg, q_gt, TOP_K)
    nnd_recall = {b: recall_at_k(_check_result(search(nnd, nnd_prov, q_gt, top_k=TOP_K, beam_width=b), GT_QUERIES,
                                               "NN-descent search"), gt_seg, TOP_K) for b in (50, 100)}
    steps["nndescent"].update(n=n_del, recall=nnd_recall, jax_recall=JAX_NNDESCENT_RECALL_20K,
                              average_degree=nnd.average_degree())
    if n_del == 20_000 and abs(nnd_recall[100] - JAX_NNDESCENT_RECALL_20K[100]) > PARITY_SLACK:
        fails.append(f"NN-descent recall@10 at beam 100 {nnd_recall[100]} vs the JAX package's "
                     f"{JAX_NNDESCENT_RECALL_20K[100]}")

    with tempfile.TemporaryDirectory() as td:
        # 5. the spliced graph (tombstones kept) and the segment compacted on disk
        t0 = time.time()
        write_index(f"{td}/spliced.jvtpu", spliced, features={"inline_vectors": {"vectors": base}}, renumber=False)
        write_index(f"{td}/nnd.jvtpu", nnd, features={"inline_vectors": {"vectors": seg}})
        save_s = time.time() - t0
        del nnd, nnd_prov
        (mappers, stats) = step("compact_on_disk", lambda: compact_on_disk(
            [f"{td}/spliced.jvtpu", f"{td}/nnd.jvtpu"], f"{td}/merged.jvtpu", cfg, wave=LIFECYCLE_WAVE,
            device_budget_bytes=LIFECYCLE_BUDGET, device=dev))
        new_of_old = np.empty(n, np.int32)
        new_of_old[live] = mappers[0][:n][live]
        new_of_old[deleted] = mappers[1]
        steps["compact_on_disk"].update(save_seconds=save_s, total=stats["total"], wave=LIFECYCLE_WAVE,
                                        budget_bytes=LIFECYCLE_BUDGET, peak_device_bytes=stats["peak_device_bytes"],
                                        allocated_peak_bytes=stats["allocated_peak_bytes"])
        if stats["total"] != n or not np.array_equal(np.sort(new_of_old), np.arange(n)):
            fails.append(f"compact_on_disk: {stats['total']} nodes, not the {n} of the corpus")

        # 6. the device tier serves the merged file
        tier = step("device_tier_load", lambda: DeviceTierIndex.load(f"{td}/merged.jvtpu", device=dev))
    gt_merged = new_of_old[gt]

    def tier_run(qs, beam):
        return tier.search(qs, top_k=TOP_K, beam_width=beam, rerank_k=beam, repack_after=max(8, int(1.6 * beam)))

    tier_recall = {b: recall_at_k(_check_result(tier_run(q_gt, b), GT_QUERIES, "device tier"), gt_merged, TOP_K)
                   for b in beams}
    steps["device_tier"] = {"recall": tier_recall, "qps_100": _qps(lambda q: tier_run(q, API_BEAM), queries),
                            "hbm_bytes": tier.hbm_bytes(),
                            "phase_max_memory_allocated": torch.cuda.max_memory_allocated()}
    if tier_recall[API_BEAM] < RECALL_FLOOR:
        fails.append(f"device tier: recall@10 at beam 100 {tier_recall[API_BEAM]} < {RECALL_FLOOR}")
    del tier, spliced, tomb, first
    torch.cuda.empty_cache()

    # 7. PQ-sidecar compaction at 20k (K5 on the path)
    t0 = time.time()
    pqc = _lifecycle_pq_compaction(dev)
    steps["pq_compaction"] = {"seconds": time.time() - t0, **pqc}
    if pqc["launches"]["adc_score_kernel"] == 0 or pqc["carried"]["launches"]["adc_score_kernel"] == 0:
        fails.append("a PQ-sidecar compaction launched no K5")
    if n == EARLIER_N:
        got, want = pqc["carried"]["recall"][100], JAX_PQ_CARRIED_RECALL_20K[100]
        if abs(got - want) > LIFECYCLE_CARRIED_SLACK:
            fails.append(f"PQ compaction on carried codebooks: recall@10 at beam 100 {got} vs the JAX "
                         f"package's {want}")
        floor = JAX_PQ_COMPACTION_RECALL_20K["min"][100] - PARITY_SLACK
        if pqc["recall"][100] < floor:
            fails.append(f"retrained PQ compaction: recall@10 at beam 100 {pqc['recall'][100]} < {floor} (the "
                         f"JAX package's lowest of eight retrain seeds less {PARITY_SLACK})")

    # 8. PQ training is a function of its seed on the card
    t0 = time.time()
    det = {}
    for name, dim, m, thr in (("pq_m16", 128, 16, -1.0), ("config3_anisotropic_pq", 96, 24, 0.2)):
        data = torch.as_tensor(synthetic_dataset(n=LIFECYCLE_DETERMINISM_ROWS, dim=dim, n_queries=1, k=1,
                                                 n_clusters=262, seed=0, device=dev).base, device=dev)
        books = [ProductQuantization.compute(data, m=m, clusters=256, globally_center=False,
                                             anisotropic_threshold=thr).codebooks for _ in range(2)]
        det[name] = {"bit_equal": bool(torch.equal(*books)), "max_abs_diff": float((books[0] - books[1]).abs().max())}
        if not det[name]["bit_equal"]:
            fails.append(f"PQ training ({name}) differs between two runs from one seed")
    steps["determinism"] = {"seconds": time.time() - t0, "rows": LIFECYCLE_DETERMINISM_ROWS, **det}

    result = {"phase": "lifecycle", "n": n, "seconds": time.time() - t_phase, "steps": steps,
              "recall_before_delete": recall_full_before, "recall_before_delete_low_beam": recall_full_before_low,
              "low_beam": LIFECYCLE_LOW_BEAM}
    emit(result)
    if fails:
        raise SystemExit(f"lifecycle: {fails}")
    return result


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

    n_waves = len(_shuffled_wave_starts(n, cfg.wave_size))
    reset_counts()
    t0 = time.time()
    with _real_wave_check(n_waves // 2) as real_wave:
        graph, exact = build_graph(base, "euclidean", cfg)
    torch.cuda.synchronize()
    build_s = time.time() - t0

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
        "phase": "sq4_path", "n": n, "dim": 128, "n_waves": n_waves, "real_wave_check": real_wave,
        "data_seconds": data_s, "build_seconds": build_s, "sq4_encode_seconds": encode_s,
        "average_degree": graph.average_degree(), "headline_beam": chosen,
        "beams": {str(b): v for b, v in sorted(points.items())}, "launches": launches,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(result)
    if not (real_wave.get("k1_bit_exact") and real_wave.get("k2_bit_exact")):
        raise SystemExit(f"K1 or K2 disagrees with its twin on a real wave's streams: {real_wave}")
    if points[100]["recall"] < RECALL_FLOOR:
        raise SystemExit(f"recall@10 at beam 100 is {points[100]['recall']} < {RECALL_FLOOR}")
    for name in ("packed_adj_update_inplace", "fused_update_inplace"):
        if launches[name] != n_waves:
            raise SystemExit(f"{name} launched {launches[name]} times over {n_waves} build waves")

    # the search API on the same graph, before its SQ4 tables go
    api, fails = _search_api_sq4(graph, exact, sq4, base, queries, gt, dev)
    emit(api)
    if fails:
        raise SystemExit(f"search API on the SQ4 graph: {fails}")
    result["search_api"] = api

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

    # the index lifecycle on the same graph, corpus and ground truth
    result["lifecycle"] = _lifecycle(graph, exact, sq, base, queries, gt, sorted({100, chosen or BEAMS[-1]}), dev)
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
    launches over its rows, then its compaction row
    (``run_compact_micro`` at ``n`` = :data:`MICRO_COMPACT_N`: two 12.5k SQ4
    segments, d = 64)."""
    from jvector_tpu_torch.bench.micro import run_compact_micro, run_micro

    reset_counts()
    t0 = time.time()
    rows = run_micro(device=dev)
    result = {"phase": "micro", "seconds": time.time() - t0, "rows": rows, "launches": read_counts(),
              "k6_launches_by_shape": read_k6_shapes("the micro")}
    reset_counts()
    t0 = time.time()
    result["rows"] += run_compact_micro(n=MICRO_COMPACT_N, device=dev)
    result["compact_seconds"] = time.time() - t0
    result["compact_launches"] = read_counts()
    emit(result)
    for name in ("adc_score_kernel", "adc16_score_kernel"):
        if result["launches"][name] == 0:
            raise SystemExit(f"the micro launched no {name}")
    return result


def _refine_rescore(graph, build_prov, first, exact, base, queries, gt, cfg, recall_before: float,
                    reference: tuple | None) -> tuple[dict, list]:
    """The search API's refine part on the default-config graph:
    ``refine_graph`` (PQ search and prune, K5 in its beam) and then
    ``rescore_graph`` (``score_nodes`` through K5) over the whole base
    layer in chunks of 1024, with recall@10 at beam 100 before and after
    the refine, held to the ``reference`` ``(before, after)`` drop plus
    :data:`REFINE_SLACK` where one is given.  Returns the line and the
    failures."""
    from jvector_tpu_torch.graph import search
    from jvector_tpu_torch.graph.builder import refine_graph, rescore_graph
    from jvector_tpu_torch.util.datasets import recall_at_k

    n = base.shape[0]
    reset_counts()
    refined, refine_s = _timed(lambda: refine_graph(graph, build_prov, base, cfg, chunk=1024))
    refine_launches = read_counts()
    refine_k5 = read_k5_shapes()
    res = search(refined, first, queries, top_k=TOP_K, beam_width=100, rerank_k=100, reranker=exact)
    after = recall_at_k(_check_result(res, queries.shape[0], "search on the refined graph"), gt, TOP_K)
    reset_counts()
    rescored, rescore_s = _timed(lambda: rescore_graph(refined, build_prov, chunk=1024))
    rescore_launches = read_counts()
    rescore_k5 = read_k5_shapes()
    old, new, cnt = refined.base.neighbors[:n], rescored.base.neighbors[:n], refined.base.counts[:n]
    valid = torch.arange(old.shape[1], device=old.device)[None, :] < cnt[:, None]
    big = torch.iinfo(torch.int32).max

    def id_sets(ids):
        return torch.sort(torch.where(valid, ids, big), dim=1).values

    sc = rescored.base.scores[:n]
    unsorted = int(((sc[:, 1:] > sc[:, :-1]) & valid[:, 1:]).any(dim=1).sum())
    changed_sets = int((id_sets(old) != id_sets(new)).any(dim=1).sum())
    line = {"phase": "search_api", "graph": "default_config", "n": n, "chunk": 1024,
            "recall_100": {"before_refine": recall_before, "after_refine": after},
            "average_degree": {"before": graph.average_degree(), "after": refined.average_degree()},
            "refine_seconds": refine_s, "rescore_seconds": rescore_s,
            "rows_with_changed_id_sets": changed_sets, "rows_unsorted": unsorted,
            "launches": {"refine": refine_launches, "rescore": rescore_launches},
            "k5_launches_by_shape": {"refine": refine_k5, "rescore": rescore_k5}}
    fails = []
    if reference is not None:
        allowed = max(0.0, reference[0] - reference[1]) + REFINE_SLACK
        line["jax_recall_100"] = {"before_refine": reference[0], "after_refine": reference[1]}
        line["allowed_drop"] = allowed
        if recall_before - after > allowed:
            fails.append(f"refine lowered recall@10 from {recall_before} to {after}, more than {allowed}")
    if changed_sets or unsorted:
        fails.append(f"rescore changed {changed_sets} rows' id sets or left {unsorted} rows unsorted")
    for name, counts in line["launches"].items():
        if counts["adc_score_kernel"] == 0:
            fails.append(f"{name} launched no K5")
    return line, fails


def phase_default_config(n: int, dev: torch.device, n_queries: int, n_clusters: int, gt_queries: int,
                         timed_beams: tuple, refine: bool = False) -> dict:
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
    build_k5 = read_k5_shapes()
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
    serve_k5 = read_k5_shapes()

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
        "k5_launches_by_shape": {"build": build_k5, "serve": serve_k5},
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(result)
    if build_launches["adc_score_kernel"] == 0 or serve_launches["adc_score_kernel"] == 0:
        raise SystemExit(f"K5 was not launched in the build or in serving: {result['launches']}")
    if graph.num_levels > 1 and (build_launches["fused_update_inplace"] == 0):
        raise SystemExit("the hierarchy's sub-builds launched no K2")
    if refine:
        del fused
        torch.cuda.empty_cache()
        line, fails = _refine_rescore(graph, build_prov, first, exact, base, queries[:gt_queries], gt, cfg,
                                      recalls[100], JAX_REFINE_200K if n == EARLIER_N else None)
        emit(line)
        if fails:
            raise SystemExit(f"search API on the default-config graph: {fails}")
        result["refine"] = line
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


def _peak_split(fn, top: int = 8) -> dict:
    """The device allocations live at the peak of ``fn()``, by tensor: the
    caching allocator's trace (``torch.cuda.memory._record_memory_history``)
    replayed to the moment its live total peaks; each allocation named by
    the innermost frame in the port.  Allocations made before ``fn`` (the
    resident index) are not in the trace."""
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(enabled="all", stacks="python", max_entries=2_000_000)
    try:
        fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    live, total, peak, at_peak = {}, 0, 0, {}
    for ev in snap["device_traces"][torch.cuda.current_device()]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            total += ev["size"]
            if total > peak:
                peak, at_peak = total, dict(live)
        elif ev["action"] in ("free_requested", "free_completed") and ev["addr"] in live:
            total -= live.pop(ev["addr"])["size"]

    def where(ev):
        frames = [f for f in ev.get("frames", []) if "jvector_tpu_torch" in f["filename"]]
        f = frames[0] if frames else (ev.get("frames") or [{"filename": "?", "line": 0, "name": "?"}])[0]
        return f"{f['filename'].split('jvector_tpu_torch/')[-1]}:{f['line']} {f['name']}"

    by_site = {}
    for ev in at_peak.values():
        by_site[where(ev)] = by_site.get(where(ev), 0) + ev["size"]
    largest = sorted(at_peak.values(), key=lambda e: -e["size"])[:top]
    return {"transient_peak_mb": peak / 2**20, "allocations_at_peak": len(at_peak),
            "largest_mb": [[where(e), e["size"] / 2**20] for e in largest],
            "by_site_mb": dict(sorted(((k, v / 2**20) for k, v in by_site.items()), key=lambda kv: -kv[1])[:top])}


def _host_search_api(hg, ds, base: np.ndarray, kw: dict, dev: torch.device) -> tuple[dict, list]:
    """The search API on the host-served index: a filtered search at
    selectivity 0.01 (over the brute cutoff: the streamed in-loop path)
    and a threshold search at the median over the queries of the exact
    10th-best score, against exact ground truth on the card."""
    from jvector_tpu_torch.graph import ExactScoreProvider
    from jvector_tpu_torch.util.datasets import recall_at_k

    n = base.shape[0]
    base_t, q_t = torch.as_tensor(base, device=dev), torch.as_tensor(ds.queries, device=dev)
    m_np = _accept_mask(np.random.default_rng(1), n, 0.01)
    fgt = _exact_topk(base_t, q_t, TOP_K, torch.as_tensor(m_np, device=dev))
    exact = ExactScoreProvider(vectors=base_t)
    gt_scores = exact.score(exact.prepare(q_t), torch.as_tensor(ds.ground_truth[:, :TOP_K], device=dev))
    thr = float(torch.median(gt_scores[:, -1]))
    del base_t, exact
    torch.cuda.empty_cache()
    reset_counts()
    res, secs = _timed(lambda: hg.search(ds.queries, accept=m_np, max_iters=400, **kw))
    ids = res.ids.cpu().numpy()
    got, t_secs = _timed(lambda: hg.search(ds.queries, threshold=thr, **kw))
    below = int((got.scores < thr)[got.ids >= 0].sum())
    above = gt_scores >= thr
    kept = ((torch.as_tensor(ds.ground_truth[:, :TOP_K], device=dev)[:, :, None] == got.ids[:, None, :]).any(dim=2)
            & above).sum()
    line = {"phase": "search_api", "graph": "ltm_host_served", "n": n, "beam_width": kw["beam_width"],
            "expand": kw["expand"],
            "filtered_0.01": {"accepted": int(m_np.sum()), "recall": recall_at_k(ids, fgt, TOP_K),
                              "holes": int((ids < 0).sum()),
                              "not_accepted": int((~m_np[np.maximum(ids, 0)] & (ids >= 0)).sum()),
                              "expanded_mean": float(res.expanded_count.float().mean()), "seconds_1024": secs},
            "threshold": {"threshold": thr, "results": int((got.ids >= 0).sum()), "below_threshold": below,
                          "retention": float(kept) / max(1, int(above.sum())), "seconds_1024": t_secs},
            "launches": read_counts()}
    f = line["filtered_0.01"]
    fails = []
    if f["holes"] or f["not_accepted"]:
        fails.append(f"host filtered: {f['holes']} holes, {f['not_accepted']} ids not accepted")
    if f["recall"] < HOST_RECALL_FLOOR:
        fails.append(f"host filtered recall@10 {f['recall']} < {HOST_RECALL_FLOOR}")
    if below:
        fails.append(f"host threshold: {below} results score below {thr}")
    return line, fails


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
        peak_split = _peak_split(lambda: hg.search(ds.queries, **kw).ids.cpu())
        host_api, host_fails = _host_search_api(hg, ds, base, kw, dev)

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
    result["serve"]["peak_split"] = peak_split
    emit(result)
    emit(host_api)
    if host_fails:
        raise SystemExit(f"search API on the host-served index: {host_fails}")
    result["search_api"] = host_api
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


def _baseline_corpus(n: int, dim: int, sim: str, seed: int, dev: torch.device, gt_queries: int):
    """``experiments/baseline_configs_demo.py``'s corpus: base and queries
    L2-normalized again, the exact dot-product top-10 of the first
    ``gt_queries`` queries on the card.  Returns numpy base and queries and
    the ground truth."""
    from jvector_tpu_torch.util.datasets import synthetic_dataset

    ds = synthetic_dataset(n=n, dim=dim, n_queries=BASELINE_QUERIES, k=TOP_K, sim=sim,
                           n_clusters=max(64, n // 500), seed=seed, device=dev)
    base, queries = ds.base, ds.queries
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    q = torch.as_tensor(queries[:gt_queries], device=dev)
    gt = torch.topk(q @ torch.as_tensor(base, device=dev).T, TOP_K, dim=1).indices.to(torch.int32).cpu().numpy()
    return base, queries, gt


def _operating(run, queries: torch.Tensor, gt: np.ndarray, what: str, beams=BASELINE_BEAMS) -> dict:
    """The demo's operating rule: recall@10 over the first 512 queries at
    every beam (printed, though the rule stops at the first beam reaching
    0.95), that beam (the last when none does), and its QPS over 8192
    queries in 1024-query waves.  Counts launches from 0."""
    from jvector_tpu_torch.util.datasets import recall_at_k

    reset_counts()
    recalls, chosen = {}, None
    for b in beams:
        ids = _check_result(run(queries[:BASELINE_GT_QUERIES], b), BASELINE_GT_QUERIES, f"{what} at beam {b}")
        recalls[b] = recall_at_k(ids, gt, TOP_K)
        if chosen is None and recalls[b] >= RECALL_FLOOR:
            chosen = b
    beam = chosen or beams[-1]
    run(queries[:BASELINE_WAVE], beam).ids.cpu()  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    for i in range(0, BASELINE_QUERIES, BASELINE_WAVE):
        run(queries[i : i + BASELINE_WAVE], beam)
    torch.cuda.synchronize()
    return {"recall": {str(b): r for b, r in recalls.items()}, "operating_beam": beam,
            "reaches_0.95": chosen is not None, "qps": BASELINE_QUERIES / (time.time() - t0),
            "launches": read_counts(), "k5_launches_by_shape": read_k5_shapes()}


def _serve_split(first_only, full, queries: torch.Tensor) -> dict:
    """Where one 1024-query wave's time goes: the wall seconds of the first
    pass alone and of the whole two-pass search (host clock, device
    synced, after a warm-up), and for the whole search its device-busy
    seconds and share and the kernels with the most device time
    (``torch.profiler``, CUDA activity only)."""
    from torch.profiler import ProfilerActivity, profile

    q = queries[:BASELINE_WAVE]
    split = {}
    for name, fn in (("first_pass_only", first_only), ("with_rerank", full)):
        fn(q).ids.cpu()
        split[f"{name}_wall_s"] = _timed(lambda f=fn: f(q))[1]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(lambda: full(q))
    ka = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in ka)
    top = sorted(ka, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    split.update(profiled_wall_s=wall, device_busy_s=dev_us / 1e6, busy_share=dev_us / 1e6 / wall,
                 top_device_ms=[(e.key[:90], e.self_device_time_total / 1e3, e.count) for e in top])
    return split


def _baseline_config3(n: int, dev: torch.device, keep_corpus: bool = False) -> dict:
    """BASELINE config 3 (deep1M-like, 96-d, dot product) at ``n``: the SQ4
    build (the fused loop's whole-row path, K4a once a wave), then on that
    graph (a) anisotropic PQ (m = 24, K = 256, uncentred, T = 0.2) through
    fused ADC (K5), (b) the same PQ with T = -1, (c) anisotropic SQ4 through
    ``provider_for_graph`` beside plain SQ4, each with exact rerank at
    ``rerank_k = beam``."""
    from jvector_tpu_torch.graph import FusedADCScoreProvider, GraphConfig, build_fused_codes, build_graph, search
    from jvector_tpu_torch.graph.builder import _shuffled_wave_starts
    from jvector_tpu_torch.quantization import ProductQuantization, ScalarQuantization4

    base_np, queries_np, gt = _baseline_corpus(n, 96, "dot_product", 7, dev, BASELINE_GT_QUERIES)
    base = torch.as_tensor(base_np, device=dev)
    queries = torch.as_tensor(queries_np, device=dev)
    cfg = GraphConfig(max_degree=32, ef_construction=100)
    n_waves = len(_shuffled_wave_starts(n, cfg.wave_size))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    (graph, exact), build_s = _timed(lambda: build_graph(base, "dot_product", cfg))
    line = {"phase": "baseline_configs", "config": 3, "n": n, "dim": 96, "n_waves": n_waves, "build_seconds": build_s,
            "build_launches": read_counts(), "average_degree": graph.average_degree(),
            "build_peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30, "serves": {}}

    def pad(codes):
        return torch.nn.functional.pad(codes, (0, 0, 0, graph.capacity - n))

    for name, thr in (("c3_aniso_pq", 0.2), ("c3_plain_pq", -1.0)):
        pq, train_s = _timed(lambda t=thr: ProductQuantization.compute(base, m=24, clusters=256,
                                                                       globally_center=False, anisotropic_threshold=t))
        codes, encode_s = _timed(lambda q=pq: pad(q.encode(base)))
        fused, fused_s = _timed(lambda c=codes: build_fused_codes(graph.base.neighbors, c))
        prov = FusedADCScoreProvider(codes=codes, fused_codes=fused, codebooks=pq.codebooks, center=pq.center,
                                     sim=exact.sim)
        serve = _operating(lambda q, b, p=prov: search(graph, p, q, top_k=TOP_K, beam_width=b, rerank_k=b,
                                                          reranker=exact), queries, gt, name)
        line["serves"][name] = {**serve, "train_seconds": train_s, "encode_seconds": encode_s,
                                "fused_table_seconds": fused_s, "compressed_size": pq.compressed_size}
        if name == "c3_aniso_pq":
            b = serve["operating_beam"]
            line["serves"][name]["split"] = _serve_split(
                lambda q, p=prov: search(graph, p, q, top_k=TOP_K, beam_width=b),
                lambda q, p=prov: search(graph, p, q, top_k=TOP_K, beam_width=b, rerank_k=b, reranker=exact),
                queries)
        del pq, codes, fused, prov
    sq = ScalarQuantization4.compute(base)
    for name, encode in (("c3_aniso_sq4", lambda: sq.encode_anisotropic(base, threshold=0.2)),
                         ("c3_plain_sq4", lambda: sq.encode(base))):
        codes, encode_s = _timed(lambda e=encode: pad(e()))
        prov, table_s = _timed(lambda c=codes: sq.provider_for_graph(c, graph.base.neighbors, "dot_product"))
        serve = _operating(lambda q, b, p=prov: search(graph, p, q, top_k=TOP_K, beam_width=b, rerank_k=b,
                                                          reranker=exact), queries, gt, name)
        line["serves"][name] = {**serve, "encode_seconds": encode_s, "fused_table_seconds": table_s,
                                "compressed_size": sq.compressed_size}
        del codes, prov
    del graph, exact, base, queries
    torch.cuda.empty_cache()
    if keep_corpus:
        line["corpus"] = (base_np, queries_np)
    return line


def _baseline_config4(n: int, dev: torch.device) -> dict:
    """BASELINE config 4 (ada-002-like, 1536-d, cosine data built and served
    as dot product) at ``n``: the SQ4 build, which at MP = 768 takes the
    packed loop (K1 and K2 once a wave, on 43,008-byte fused rows; its
    middle wave re-applied through their twins), then a BQ first pass with
    NVQ rerank at ``rerank_k = beam``, and an FP32 rerank at the chosen
    beam for what NVQ costs."""
    from jvector_tpu_torch.graph import GraphConfig, build_graph, search
    from jvector_tpu_torch.graph.builder import _shuffled_wave_starts
    from jvector_tpu_torch.quantization import BinaryQuantization, NVQuantization

    base_np, queries_np, gt = _baseline_corpus(n, 1536, "cosine", 8, dev, BASELINE_GT_QUERIES)
    base = torch.as_tensor(base_np, device=dev)
    queries = torch.as_tensor(queries_np, device=dev)
    del base_np, queries_np
    cfg = GraphConfig(max_degree=32, ef_construction=100)
    n_waves = len(_shuffled_wave_starts(n, cfg.wave_size))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with _real_wave_check(n_waves // 2) as real_wave:
        (graph, exact), build_s = _timed(lambda: build_graph(base, "dot_product", cfg))
    line = {"phase": "baseline_configs", "config": 4, "n": n, "dim": 1536, "n_waves": n_waves,
            "build_seconds": build_s, "build_launches": read_counts(), "real_wave_check": real_wave,
            "average_degree": graph.average_degree(),
            "build_peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30}
    bq, bq_s = _timed(lambda: BinaryQuantization.compute(base))
    codes, bq_encode_s = _timed(lambda: bq.encode(base))
    nvq, nvq_s = _timed(lambda: NVQuantization.compute(base))
    vecs, nvq_encode_s = _timed(lambda: nvq.encode(base))
    first, rerank = bq.provider(codes), vecs.provider("dot_product")
    serve = _operating(lambda q, b: search(graph, first, q, top_k=TOP_K, beam_width=b, rerank_k=b, reranker=rerank),
                       queries, gt, "c4_bq_nvq")
    fp32 = _operating(lambda q, b: search(graph, first, q, top_k=TOP_K, beam_width=b, rerank_k=b, reranker=exact),
                      queries, gt, "c4_bq_fp32")
    b = serve["operating_beam"]
    serve["split"] = _serve_split(
        lambda q: search(graph, first, q, top_k=TOP_K, beam_width=b),
        lambda q: search(graph, first, q, top_k=TOP_K, beam_width=b, rerank_k=b, reranker=rerank), queries)
    line["serves"] = {
        "c4_bq_nvq": {**serve, "bq_compute_seconds": bq_s, "bq_encode_seconds": bq_encode_s,
                      "nvq_compute_seconds": nvq_s, "nvq_encode_seconds": nvq_encode_s,
                      "bq_compressed_size": bq.compressed_size, "nvq_compressed_size": vecs.compressed_size},
        "c4_bq_fp32": fp32,
    }
    del graph, exact, base, queries, codes, vecs, first, rerank
    torch.cuda.empty_cache()
    return line


def _baseline_grid(base: np.ndarray, queries: np.ndarray, dev: torch.device) -> dict:
    """``jvector_tpu_torch.bench.grid.Grid`` on config 3's 20k corpus (1024
    queries, one wave a row): anisotropic PQ construction (mFactor 4, K =
    256, uncentred, T = 0.2), search compression PQ (the same entry), BQ
    and FUSED_PQ, reranking FP32 and NVQ, topK 10 at overquery 2 and 6,
    with a compressor cache in a temporary directory; then the same grid
    run again, which must load every compressor and train none."""
    import tempfile

    from jvector_tpu_torch.bench.grid import Grid, GridConfig
    from jvector_tpu_torch.ops.similarity import SimilarityFunction
    from jvector_tpu_torch.util.datasets import DataSet

    q = queries[:BASELINE_WAVE]
    gt = torch.topk(torch.as_tensor(q, device=dev) @ torch.as_tensor(base, device=dev).T, TOP_K,
                    dim=1).indices.to(torch.int32).cpu().numpy()
    ds = DataSet(name=f"deep1M-like-{base.shape[0]}", similarity=SimilarityFunction.DOT_PRODUCT, base=base,
                 queries=q, ground_truth=gt)
    pq = {"type": "PQ", "mFactor": 4, "k": 256, "centerData": False, "anisotropicThreshold": 0.2}
    cfg = GridConfig(compression=[pq], search_compression=[pq, {"type": "BQ"}, {"type": "FUSED_PQ", "mFactor": 4,
                                                                                "k": 256}],
                     reranking=["FP32", "NVQ"], top_k_overquery={10: [2.0, 6.0]}, wave_size=BASELINE_WAVE)
    line = {"phase": "baseline_grid", "n": base.shape[0], "queries": BASELINE_WAVE, "runs": []}
    with tempfile.TemporaryDirectory(prefix="jvtpu-grid-") as cache:
        grid = Grid(ds, cfg, compressor_cache_dir=cache, device=dev)
        trained = []
        cached = grid._trained
        grid._trained = lambda kind, params, train: cached(kind, params, lambda: (trained.append(kind), train())[1])
        for _ in range(2):
            before = len(trained)
            reset_counts()
            rows, secs = _timed(lambda: grid.run(verbose=False))
            line["runs"].append({
                "seconds": secs, "trained": trained[before:], "launches": read_counts(),
                "rows": [{k: r[k] for k in ("buildCompression", "compression", "reranking", "topK", "overquery",
                                            "recall", "qps_avg", "index_build_time_s", "quant_time_s")}
                         for r in rows[-12:]]})
        line["cache_files"] = len(os.listdir(cache))
    line["row_keys"] = sorted(rows[-1])
    return line


def phase_baseline_configs(n: int, dev: torch.device) -> dict:
    """BASELINE configs 3 and 4 (see the module docstring): the 20k parity
    cells and the grid first, then both configs at ``min(n, 200,000)``."""
    fails = []

    def check_builds(line: dict) -> None:
        b, waves = line["build_launches"], line["n_waves"]
        if line["config"] == 3 and b["scatter_rows3_inplace"] != waves:
            fails.append(f"config 3 at {line['n']}: K4a launched {b['scatter_rows3_inplace']} times over {waves} waves")
        if line["config"] == 4:
            for name in ("packed_adj_update_inplace", "fused_update_inplace"):
                if b[name] != waves:
                    fails.append(f"config 4 at {line['n']}: {name} launched {b[name]} times over {waves} waves")
            rw = line["real_wave_check"]
            if not (rw.get("k1_bit_exact") and rw.get("k2_bit_exact")):
                fails.append(f"config 4: K1 or K2 disagrees with its twin on a real wave: {rw}")
        if line["config"] == 3 and line["serves"]["c3_aniso_pq"]["launches"]["adc_score_kernel"] == 0:
            fails.append(f"config 3 at {line['n']}: serve (a) launched no K5")

    t0 = time.time()
    lines = {}
    c3 = _baseline_config3(BASELINE_PARITY_N, dev, keep_corpus=True)
    c4 = _baseline_config4(BASELINE_PARITY_N, dev)
    parity = {}
    for line in (c3, c4):
        check_builds(line)
        for name, serve in line["serves"].items():
            ref = JAX_BASELINE_20K[name]
            parity[name] = {"port": serve["recall"], "jax": {str(b): r for b, r in ref.items()},
                            "port_minus_jax": {str(b): serve["recall"][str(b)] - r for b, r in ref.items()}}
            if name in BASELINE_PARITY_HELD:
                off = {b: parity[name]["port_minus_jax"][str(b)] for b in BASELINE_PARITY_BEAMS}
                if any(abs(d) > PARITY_SLACK for d in off.values()):
                    fails.append(f"20k {name} recall is off the JAX figures by more than {PARITY_SLACK}: {off}")
    base20, queries20 = c3.pop("corpus")
    for line in (c3, c4):
        emit(line)
    emit({"phase": "baseline_parity", "n": BASELINE_PARITY_N, "held": list(BASELINE_PARITY_HELD),
          "beams": list(BASELINE_PARITY_BEAMS), "slack": PARITY_SLACK, "serves": parity})
    grid = _baseline_grid(base20, queries20, dev)
    del base20, queries20
    emit(grid)
    if grid["runs"][1]["trained"]:
        fails.append(f"the grid's second run trained {grid['runs'][1]['trained']}")
    if len(grid["runs"][0]["trained"]) != 4:
        fails.append(f"the grid's first run trained {grid['runs'][0]['trained']}, not PQ, BQ, PQ and NVQ once each")
    lines["parity_20k"] = {"config3": c3, "config4": c4, "parity": parity}
    lines["grid"] = grid

    big = min(n, BASELINE_N)
    for config in (_baseline_config3, _baseline_config4):
        line = config(big, dev)
        check_builds(line)
        line["readme_tpu_v5e"] = {k: v for k, v in README_TPU_V5E.items() if k in line["serves"]}
        emit(line)
        lines[f"config{line['config']}"] = line
        held = "c3_aniso_pq" if line["config"] == 3 else "c4_bq_nvq"
        r120 = line["serves"][held]["recall"]["120"]
        if big == BASELINE_N and r120 < BASELINE_FLOOR_200K:
            fails.append(f"{held} at {big}: recall@10 at beam 120 is {r120} < {BASELINE_FLOOR_200K}")
    lines["seconds"] = time.time() - t0
    emit({"phase": "baseline_configs_done", "seconds": lines["seconds"], "fails": fails})
    if fails:
        raise SystemExit(f"baseline configs: {fails}")
    return lines



def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 24), b""):
            h.update(blk)
    return h.hexdigest()


def _brute_same_sets(brute: np.ndarray, base: torch.Tensor, queries: torch.Tensor, k: int) -> int:
    """Queries whose sharded brute-force top-k differs as a set from
    ``_exact_topk``'s, after ties: a differing id must lie within 1e-5 of the
    k-th distance (float64), or the script fails.  Returns the tie count."""
    want = _exact_topk(base, queries, k)
    ties = 0
    for qi in np.flatnonzero([set(a.tolist()) != set(b.tolist()) for a, b in zip(brute, want)]):
        q = queries[qi].double()
        d = lambda ids: ((base[torch.as_tensor(ids, device=base.device)].double() - q) ** 2).sum(1)  # noqa: E731
        kth = float(d(want[qi]).max())
        if float(d(brute[qi]).max()) > kth * (1 + 1e-5) + 1e-9:
            raise SystemExit(f"sharded brute force differs from the exact top-{k} at query {qi}")
        ties += 1
    return ties


def phase_sharding(dev: torch.device) -> dict:
    """Phase 12: the sharded in-memory build over a mesh (K1 and K2 once
    per shard per wave), its serve, the query-parallel serve, sharded
    persistence, the sharded on-disk build served from the host, and the
    multi-device dry run."""
    from jvector_tpu_torch import entry
    from jvector_tpu_torch.bench.diagnostics import StepTimer, device_memory_stats
    from jvector_tpu_torch.disk import HostGraphIndex, ShardedHostIndex
    from jvector_tpu_torch.graph import GraphConfig, search
    from jvector_tpu_torch.graph.builder import _shuffled_wave_starts
    from jvector_tpu_torch.parallel import (
        load_sharded,
        make_mesh,
        save_sharded,
        sharded_brute_force,
        sharded_build,
        sharded_build_on_disk,
        sharded_graph_search,
        sharded_search,
    )
    from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset

    visible = torch.cuda.device_count()
    mesh = make_mesh(devices=[f"cuda:{i}" for i in range(visible)] if visible >= 4 else [dev] * SHARD_COUNT,
                     axis_name="shard")
    mesh_devices = [str(d) for d in mesh.devices]
    print(f"sharding mesh: {mesh_devices}", flush=True)
    cards = sorted(set(mesh.devices), key=str)
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    timer = StepTimer(dev)
    fails, out = [], {"phase": "sharding", "n": SHARD_N, "dim": 128, "mesh": mesh_devices}
    with timer.section("data"):
        ds = synthetic_dataset(n=SHARD_N, dim=128, n_queries=SHARD_QUERIES, k=TOP_K,
                               n_clusters=max(64, SHARD_N // 500), seed=0, device=dev)
        base = torch.as_tensor(ds.base, device=dev)
        queries = torch.as_tensor(ds.queries, device=dev)
    q_gt, gt = queries[:GT_QUERIES], ds.ground_truth[:GT_QUERIES]
    cfg = GraphConfig(max_degree=32, ef_construction=100)

    reset_counts()
    with timer.section("build"):
        idx = sharded_build(ds.base, mesh, cfg)
    launches = {"build": read_counts()}
    n_waves = len(_shuffled_wave_starts(idx.n_local, cfg.wave_size))
    out.update(n_local=idx.n_local, n_waves_per_shard=n_waves,
               packed=idx.search_providers is not None and idx.search_providers[0].fused_w2.dtype == torch.int32,
               average_degree=[g.average_degree() for g in idx.graphs])
    for name in ("packed_adj_update_inplace", "fused_update_inplace"):
        if launches["build"][name] != mesh.size * n_waves:
            fails.append(f"{name} launched {launches['build'][name]} times, not {mesh.size} shards x {n_waves} waves")
    if not out["packed"]:
        fails.append("the sharded build did not take the packed regime")

    # the exact top-10 by node-sharded brute force
    with timer.section("brute_force"):
        _, bids = sharded_brute_force(q_gt, base, mesh, k=TOP_K)
    out["brute_force_ties"] = _brute_same_sets(bids.cpu().numpy(), base, q_gt, TOP_K)

    # the sharded serve: per-shard beam + exact rerank + merge
    reset_counts()
    recall = {}
    for beam in SHARD_BEAMS:
        with timer.section(f"serve_beam_{beam}"):
            gids, scores = sharded_graph_search(idx, q_gt, mesh, top_k=TOP_K, beam_width=beam, rerank_k=beam)
        ids = _check_result(SimpleNamespace(ids=gids, scores=scores), GT_QUERIES, f"sharded serve at beam {beam}")
        recall[str(beam)] = recall_at_k(ids, gt, TOP_K)
    launches["serve"] = read_counts()
    before_save = gids.cpu().numpy()
    floor_ids, _ = sharded_graph_search(idx, q_gt, mesh, top_k=TOP_K, beam_width=100, rerank_k=100,
                                        floor_slack=SHARD_FLOOR_SLACK)
    waves = [queries[i : i + WAVE] for i in range(0, SHARD_QUERIES, WAVE)]
    timed = waves * max(1, -(-MIN_TIMED_QUERIES // SHARD_QUERIES))
    sharded_graph_search(idx, waves[0], mesh, top_k=TOP_K, beam_width=100, rerank_k=100)  # warm-up
    with timer.section("qps_beam_100"):
        for wv in timed:
            sharded_graph_search(idx, wv, mesh, top_k=TOP_K, beam_width=100, rerank_k=100)
    out.update(recall=recall, jax_recall=JAX_SHARDED_RECALL_100K,
               qps_beam_100=len(timed) * WAVE / timer.sections["qps_beam_100"], timed_queries=len(timed) * WAVE,
               floor_slack={"slack": SHARD_FLOOR_SLACK, "recall_beam_100": recall_at_k(floor_ids.cpu().numpy(), gt,
                                                                                       TOP_K),
                            "jax_recall_beam_100": JAX_SHARDED_FLOOR_RECALL_100K})
    if recall["100"] < RECALL_FLOOR:
        fails.append(f"sharded recall@10 at beam 100 is {recall['100']} < {RECALL_FLOOR}")
    if abs(recall["100"] - JAX_SHARDED_RECALL_100K[100]) > SHARD_PARITY_SLACK:
        fails.append(f"sharded recall@10 at beam 100 is {recall['100']}, the JAX package's "
                     f"{JAX_SHARDED_RECALL_100K[100]} (slack {SHARD_PARITY_SLACK})")

    # the query-parallel serve of one shard's graph equals a one-device search
    g0, sp0, ep0 = idx.graphs[0], idx.search_providers[0], idx.providers[0]
    kw = dict(top_k=TOP_K, beam_width=100, rerank_k=100, reranker=ep0)
    with timer.section("data_parallel_serve"):
        dp = sharded_search(g0, sp0, queries, mesh, **kw)
    one = search(g0, sp0, queries, **kw)
    out["data_parallel_equal"] = bool(torch.equal(dp.ids.to(dev), one.ids))
    if not out["data_parallel_equal"]:
        fails.append("sharded_search ids differ from the one-device search")

    with tempfile.TemporaryDirectory() as td:
        # persistence: save -> load -> the same ids; one shard file served alone
        with timer.section("save"):
            save_sharded(idx, td)
        out["saved_bytes"] = sum(os.path.getsize(os.path.join(td, f)) for f in os.listdir(td))
        with timer.section("load"):
            idx2 = load_sharded(td, mesh)
        after, _ = sharded_graph_search(idx2, q_gt, mesh, top_k=TOP_K, beam_width=100, rerank_k=100)
        out["reload_ids_equal"] = bool(np.array_equal(after.cpu().numpy(), before_save))
        if not out["reload_ids_equal"]:
            fails.append("ids changed through save_sharded / load_sharded")
        del idx2
        hg = HostGraphIndex.load(os.path.join(td, "shard0000.jvtpu"), device=dev)
        res = hg.search(q_gt, top_k=TOP_K, beam_width=HOST_BEAM, expand=HOST_EXPAND)
        shard0_gt = _exact_topk(base[: idx.n_local], q_gt, TOP_K)
        out["shard0_host_recall"] = recall_at_k(res.ids.cpu().numpy(), shard0_gt, TOP_K)
        if out["shard0_host_recall"] < HOST_RECALL_FLOOR:
            fails.append(f"shard 0's file served by HostGraphIndex: recall {out['shard0_host_recall']}")
        del hg, idx
        torch.cuda.empty_cache()

    # the sharded larger-than-memory build, served from the host
    ltm_base = ds.base[:SHARD_LTM_N]
    ltm_gt = _exact_topk(base[:SHARD_LTM_N], q_gt, TOP_K)
    reads = []

    def loader(a, b):
        reads.append((a, b))
        return ltm_base[a:b]

    with tempfile.TemporaryDirectory() as td:
        reset_counts()
        with timer.section("on_disk_build"):
            man = sharded_build_on_disk(td, loader, n=SHARD_LTM_N, dim=128, shards=SHARD_LTM_SHARDS, config=cfg,
                                        device=dev)
        launches["on_disk_build"] = read_counts()
        files = [os.path.join(td, f) for f in man["shards"]]
        digests = [_sha256(f) for f in files]
        reset_counts()
        sh = ShardedHostIndex.load(td, device=dev)
        with timer.section("host_serve"):
            res = sh.search(q_gt, top_k=TOP_K, beam_width=HOST_BEAM, expand=HOST_EXPAND)
        host_recall = recall_at_k(res.ids.cpu().numpy(), ltm_gt, TOP_K)
        mask = _accept_mask(np.random.default_rng(0), SHARD_LTM_N, SHARD_FILTER)
        with timer.section("host_filtered"):
            fres = sh.search(q_gt, top_k=TOP_K, beam_width=HOST_BEAM, expand=HOST_EXPAND, accept=mask)
        launches["host_serve"] = read_counts()
        fids = fres.ids.cpu().numpy()
        outside = int(((fids >= 0) & ~mask[np.maximum(fids, 0)]).sum())
        f_gt = _exact_topk(base[:SHARD_LTM_N], q_gt, TOP_K, torch.as_tensor(mask, device=dev))
        del sh
        n_reads = len(reads)
        with timer.section("on_disk_rerun"):
            sharded_build_on_disk(td, loader, n=SHARD_LTM_N, dim=128, shards=SHARD_LTM_SHARDS, config=cfg,
                                  device=dev)
        rerun_untouched = [_sha256(f) for f in files] == digests and len(reads) == n_reads
        mesh2 = make_mesh(devices=list(mesh.devices[:SHARD_LTM_SHARDS]), axis_name="shard")
        with timer.section("on_disk_load_sharded"):
            lidx = load_sharded(td, mesh2)
        lids, _ = sharded_graph_search(lidx, q_gt, mesh2, top_k=TOP_K, beam_width=HOST_BEAM, rerank_k=HOST_BEAM)
        mesh_recall = recall_at_k(lids.cpu().numpy(), ltm_gt, TOP_K)
        del lidx
    out["on_disk"] = {
        "n": SHARD_LTM_N, "shards": SHARD_LTM_SHARDS, "host_recall_beam_64": host_recall,
        "filtered": {"selectivity": SHARD_FILTER, "recall": recall_at_k(fids, f_gt, TOP_K),
                     "ids_outside_mask": outside},
        "rerun_untouched": rerun_untouched, "load_sharded_recall_beam_64": mesh_recall,
    }
    if host_recall < HOST_RECALL_FLOOR:
        fails.append(f"ShardedHostIndex recall@10 at beam {HOST_BEAM} is {host_recall} < {HOST_RECALL_FLOOR}")
    if outside or (fids < 0).any():
        fails.append(f"the {SHARD_FILTER} filter returned {outside} ids outside the mask or empty slots")
    if not rerun_untouched:
        fails.append("a re-run of sharded_build_on_disk touched committed shards")
    if mesh_recall < HOST_RECALL_FLOOR:
        fails.append(f"load_sharded of the on-disk shards: recall@10 {mesh_recall} < {HOST_RECALL_FLOOR}")

    reset_counts()
    with timer.section("dryrun_multichip"):
        entry.dryrun_multichip(mesh.size, devices=mesh.devices)
    launches["dryrun"] = read_counts()
    out.update(seconds=timer.report(), launches=launches,
               peak_memory={str(d): device_memory_stats(d) for d in cards})
    emit(out)
    if fails:
        raise SystemExit(f"sharding phase: {fails}")
    return out


def _ipc_rows(rows: np.ndarray) -> str:
    """``WRITE`` / ``SEARCH`` vector groups, each float32 as ``'%.9g'`` (nine
    significant digits give the same float32 back)."""
    return " ".join("[" + ",".join("%.9g" % x for x in row) + "]" for row in rows.tolist())


def _ipc_session(svc, ds, tmp: str, fails: list) -> dict:
    """One IPC session on ``svc`` over ``ds``, then a second connection that
    LOADs what the first SAVEd; every reply starting ``ERROR`` fails."""
    from jvector_tpu_torch.bench.ipc import IPCClient
    from jvector_tpu_torch.util.datasets import recall_at_k

    out, launches = {"steps": {}}, {}
    queries = ds.queries[:HARNESS_IPC_QUERIES]
    search_cmds = [f"SEARCH {API_BEAM} {TOP_K} " + _ipc_rows(queries[i : i + HARNESS_IPC_CHUNK])
                   for i in range(0, HARNESS_IPC_QUERIES, HARNESS_IPC_CHUNK)]

    def call(client, step: str, cmd: str, want: str | None = None) -> str:
        reply = client.call(cmd)
        if reply.startswith("ERROR") or (want is not None and reply != want):
            fails.append(f"IPC {step}: {reply[:300]!r}" + (f", expected {want!r}" if want else ""))
        return reply

    def timed_step(name: str, fn):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        value = fn()
        torch.cuda.synchronize()
        out["steps"][name] = time.time() - t0
        launches[name] = read_counts()
        return value

    def write(client, lo: int, hi: int) -> None:
        for i in range(lo, hi, HARNESS_WRITE_ROWS):
            call(client, "WRITE", "WRITE " + _ipc_rows(ds.base[i : min(i + HARNESS_WRITE_ROWS, hi)]), "OK")

    def searches(client) -> list[str]:
        return [call(client, "SEARCH", cmd) for cmd in search_cmds]

    path = os.path.join(tmp, "ipc_index.jvtpu")
    c = IPCClient(svc.socket_path)
    try:
        call(c, "CREATE", f"CREATE {ds.dimension} euclidean 32 100", "OK")
        timed_step("write_80k", lambda: write(c, 0, HARNESS_IPC_FIRST))
        timed_step("optimize", lambda: call(c, "OPTIMIZE", "OPTIMIZE", f"OK {HARNESS_IPC_FIRST}"))
        timed_step("write_20k", lambda: write(c, HARNESS_IPC_FIRST, HARNESS_N))
        timed_step("optimize_add_nodes", lambda: call(c, "OPTIMIZE", "OPTIMIZE", f"OK {HARNESS_N}"))
        results = timed_step("search", lambda: searches(c))
        memory = call(c, "MEMORY", "MEMORY")
        timed_step("save", lambda: call(c, "SAVE", f"SAVE {path}", "OK"))
    finally:
        c.close()
    c = IPCClient(svc.socket_path)
    try:
        timed_step("load", lambda: call(c, "LOAD", f"LOAD {path}", f"OK {HARNESS_N}"))
        reloaded = timed_step("search_after_load", lambda: searches(c))
    finally:
        c.close()

    ids = np.full((HARNESS_IPC_QUERIES, TOP_K), -1, np.int64)
    rows = [r for reply in results if reply.startswith("RESULT ") for r in reply[len("RESULT "):].split(";")]
    for q, r in enumerate(rows[:HARNESS_IPC_QUERIES]):
        got = [int(x) for x in r.split()][:TOP_K]
        ids[q, : len(got)] = got
    recall = recall_at_k(ids, ds.ground_truth[:HARNESS_IPC_QUERIES], TOP_K)
    n_waves = -(-HARNESS_IPC_FIRST // HARNESS_IPC_WAVE)
    mem_floor = HARNESS_N * 32 * 4 + HARNESS_N * ds.dimension * 4  # adjacency + vectors
    mem_ceiling = torch.cuda.max_memory_allocated()
    mem = int(memory.split()[1]) if memory.startswith("OK ") and memory.split()[1].isdigit() else -1
    out.update({
        "n_waves": n_waves, "result_rows": len(rows), "recall_at_10": recall,
        "memory_bytes": mem, "memory_floor": mem_floor, "max_memory_allocated": mem_ceiling,
        "identical_after_load": reloaded == results,
        "write_vectors_per_s": HARNESS_N / (out["steps"]["write_80k"] + out["steps"]["write_20k"]),
        "search_qps": HARNESS_IPC_QUERIES / out["steps"]["search"],
        "launches": launches,
    })
    for k in ("packed_adj_update_inplace", "fused_update_inplace"):
        if launches["optimize"][k] != n_waves:
            fails.append(f"IPC OPTIMIZE launched {k} {launches['optimize'][k]} times, expected {n_waves}")
    if len(rows) != HARNESS_IPC_QUERIES or recall < RECALL_FLOOR:
        fails.append(f"IPC SEARCH: {len(rows)} result rows, recall@10 {recall} (floor {RECALL_FLOOR})")
    if not mem_floor <= mem <= mem_ceiling:
        fails.append(f"IPC MEMORY {memory!r} outside [{mem_floor}, {mem_ceiling}]")
    if reloaded != results:
        fails.append("the RESULT lines after SAVE / LOAD differ")
    return out


def _bench_cli(catalog: str, config: str, tmp: str, fails: list) -> dict:
    """``python -m jvector_tpu_torch.bench`` in-process (so the launch
    counters can be read) over the catalog entry and ``config``."""
    from jvector_tpu_torch.bench.__main__ import main as bench_main

    reports = os.path.join(tmp, "reports")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    rc = bench_main([HARNESS_DATASET, "--config", config, "--catalog", catalog, "--output", reports])
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = read_counts()
    files = sorted(os.listdir(reports)) if os.path.isdir(reports) else []
    rows = []
    for f in files:
        if f.endswith(".jsonl"):
            with open(os.path.join(reports, f)) as fh:
                rows += [json.loads(line) for line in fh]
    n_waves = -(-HARNESS_N // HARNESS_CLI_WAVE)
    table = {str(r["overquery"]): {"recall": r["recall"], "jax_recall": JAX_CLI_RECALL_100K.get(r["overquery"]),
                                   "qps_avg": r["qps_avg"], "index_build_time_s": r["index_build_time_s"],
                                   "compression": r["compression"], "reranking": r["reranking"]} for r in rows}
    out = {"rc": rc, "seconds": secs, "files": files, "n_waves": n_waves, "rows": table,
           "jax_cli_seconds": HARNESS_JAX_CLI_SECONDS, "launches": launches}
    if rc != 0 or [f.rsplit(".", 1)[1] for f in files] != ["csv", "jsonl"]:
        fails.append(f"bench CLI: rc {rc}, reports {files}")
    if sorted(r["overquery"] for r in rows) != sorted(JAX_CLI_RECALL_100K) or any(
            r["topK"] != TOP_K or r["compression"] != "SQ4" or r["reranking"] != "FP32" for r in rows):
        fails.append(f"bench CLI rows: {[(r['topK'], r['overquery'], r['compression']) for r in rows]}")
    for k in ("packed_adj_update_inplace", "fused_update_inplace"):
        if launches[k] != n_waves:
            fails.append(f"bench CLI launched {k} {launches[k]} times, expected {n_waves}")
    for r in rows:
        ref = JAX_CLI_RECALL_100K.get(r["overquery"])
        if ref is None or abs(r["recall"] - ref) > HARNESS_CLI_SLACK:
            fails.append(f"bench CLI recall {r['recall']} at overquery {r['overquery']}, JAX {ref}")
    top = [r["recall"] for r in rows if r["overquery"] == max(JAX_CLI_RECALL_100K)]
    if not top or top[0] < RECALL_FLOOR:
        fails.append(f"bench CLI recall@10 at overquery {max(JAX_CLI_RECALL_100K)}: {top} < {RECALL_FLOOR}")
    return out


def phase_harness(dev: torch.device) -> dict:
    """Phase 13: the IPC service and the bench CLI over the catalog's
    synth-100k, on the card."""
    from jvector_tpu_torch.bench.ipc import IPCService
    from jvector_tpu_torch.util.catalog import Catalog

    t_phase = time.time()
    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "yaml-configs")
    catalog = os.path.join(configs, "dataset-catalogs", "local.yml")
    ds, data_s = _timed(lambda: Catalog.load(catalog).open(HARNESS_DATASET, device=dev))
    fails = []
    if (ds.base.shape, ds.queries.shape, ds.ground_truth.shape) != ((HARNESS_N, 128), (2048, 128), (2048, 100)):
        fails.append(f"{HARNESS_DATASET}: {ds.base.shape}, {ds.queries.shape}, {ds.ground_truth.shape}")
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="jvh") as tmp:
        svc = IPCService(os.path.join(tmp, "ipc.sock"), device=dev)
        svc.start()
        try:
            ipc = _ipc_session(svc, ds, tmp, fails)
        finally:
            svc.stop()
        del ds
        torch.cuda.empty_cache()
        cli = _bench_cli(catalog, os.path.join(configs, "sq4.yml"), tmp, fails)
    out = {"phase": "harness", "dataset": HARNESS_DATASET, "n": HARNESS_N, "dim": 128, "data_seconds": data_s,
           "ipc": ipc, "cli": cli, "seconds": time.time() - t_phase, "fails": fails}
    emit(out)
    if fails:
        raise SystemExit(f"harness phase: {fails}")
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=200_000,
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
                               gt_queries=GT_QUERIES, timed_beams=(20, 100), refine=True)
    if n_earlier == EARLIER_N and big["recall"]["100"] < SANITY_FLOOR_200K:
        raise SystemExit(f"recall@10 at beam 100 is {big['recall']['100']} < {SANITY_FLOOR_200K}")
    lut16_20k = phase_lut16_parity(dev)
    micro = phase_micro(dev)
    base_cfg = phase_baseline_configs(args.n, dev)
    shard = phase_sharding(dev)
    harness = phase_harness(dev)

    main_path = {"packed_adj_update_inplace": ("sq4_path", "baseline_c4_build", "sharding", "ipc_optimize",
                                               "bench_cli"),
                 "fused_update_inplace": ("sq4_path", "baseline_c4_build", "sharding", "ipc_optimize", "bench_cli"),
                 "packed_adj_only_update_inplace": ("ltm_build",),
                 "scatter_rows3_inplace": ("mips_96d_build", "baseline_c3_build"), "scatter_rows_inplace": (),
                 "scatter_slots_inplace": (),
                 "adc_score_kernel": ("default_config_build", "default_config_serve", "default_config_refine",
                                      "default_config_rescore", "baseline_c3_serve_a", "baseline_c3_serve_b",
                                      "lifecycle_pq_compaction", "lifecycle_pq_compaction_carried"),
                 "adc16_score_kernel": ("lut16_serve", "micro"),
                 "frontier_filter": ("mips_96d_build", "mips_96d_serve", "sq4_path", "default_config_build",
                                     "default_config_serve", "ltm_serve", "search_api_filtered", "baseline_c4_serve",
                                     "sharding", "sharding_serve")}
    c3, c4 = base_cfg["config3"], base_cfg["config4"]
    c3_20k, c4_20k = base_cfg["parity_20k"]["config3"], base_cfg["parity_20k"]["config4"]

    def serves(line: dict, *names: str) -> dict:
        return {k: sum(line["serves"][s]["launches"][k] for s in names) for k in line["build_launches"]}
    mips, adv = robust["mips_96d"]["launches"], robust["clustered_adversarial"]["launches"]
    api = sq4["search_api"]
    for k in kernels:
        name = k["name"]
        by_path = {"mips_96d_build": mips["build"][name], "mips_96d_serve": mips["serve"][name],
                   "lut16_mips_96d": mips["lut16"][name],
                   "adversarial_build": adv["build"][name], "adversarial_serve": adv["serve"][name],
                   "sq4_path": sq4["launches"][name], "lut16_serve": sq4["lut16"]["launches"][name],
                   "lut16_20k": lut16_20k["launches"][name], "micro": micro["launches"][name],
                   "default_config_build": big["launches"]["build"][name],
                   "default_config_serve": big["launches"]["serve"][name],
                   "ltm_build": ltm["launches"]["build"][name],
                   "ltm_serve": ltm["launches"]["serve"][name],
                   "ltm_pq_20k": ltm["launches"]["pq_20k"][name],
                   "default_config_refine": big["refine"]["launches"]["refine"][name],
                   "default_config_rescore": big["refine"]["launches"]["rescore"][name],
                   "search_api_filtered": sum(r["launches"][name] for r in api["filtered"].values()),
                   "search_api_multi_index_build": api["multi_index"]["build_launches"][name],
                   "search_api_host": ltm["search_api"]["launches"][name],
                   "baseline_c3_build": c3["build_launches"][name],
                   "baseline_c3_serve_a": serves(c3, "c3_aniso_pq")[name],
                   "baseline_c3_serve_b": serves(c3, "c3_plain_pq")[name],
                   "baseline_c3_serve_c": serves(c3, "c3_aniso_sq4", "c3_plain_sq4")[name],
                   "baseline_c4_build": c4["build_launches"][name],
                   "baseline_c4_serve": serves(c4, "c4_bq_nvq", "c4_bq_fp32")[name],
                   "baseline_parity_20k": (c3_20k["build_launches"][name] + c4_20k["build_launches"][name]
                                           + serves(c3_20k, *c3_20k["serves"])[name]
                                           + serves(c4_20k, *c4_20k["serves"])[name]),
                   "baseline_grid": sum(r["launches"][name] for r in base_cfg["grid"]["runs"]),
                   "lifecycle_pq_compaction": sq4["lifecycle"]["steps"]["pq_compaction"]["launches"][name],
                   "lifecycle_pq_compaction_carried":
                       sq4["lifecycle"]["steps"]["pq_compaction"]["carried"]["launches"][name],
                   "micro_compact": micro["compact_launches"][name],
                   "sharding": shard["launches"]["build"][name],
                   "sharding_serve": shard["launches"]["serve"][name],
                   "sharding_on_disk_build": shard["launches"]["on_disk_build"][name],
                   "sharding_host_serve": shard["launches"]["host_serve"][name],
                   "sharding_dryrun": shard["launches"]["dryrun"][name],
                   "ipc_optimize": harness["ipc"]["launches"]["optimize"][name],
                   "ipc_add_nodes": harness["ipc"]["launches"]["optimize_add_nodes"][name],
                   "ipc_search": (harness["ipc"]["launches"]["search"][name]
                                  + harness["ipc"]["launches"]["search_after_load"][name]),
                   "bench_cli": harness["cli"]["launches"][name]}
        k["launches"] = sum(by_path[path] for path in main_path[name])
        k["launches_by_path"] = by_path
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(torch.cuda.current_device()),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
