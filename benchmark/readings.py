"""Readings that set the benchmark's fixed choices, on the card; never part
of a benchmark run.

    # recall@10 and the score gap by beam over one wave of a cell's queries
    python3 benchmark/readings.py sweep --workload angular-bq-nvq-batch --seed 11 --beams 40,60,80
    # the numbers compared, for the program or its control, over several
    # seeds in one process (each seed a whole run of the cell)
    python3 benchmark/readings.py runs --workload euclidean-sq4-batch --seeds 1,2,3 --seconds 10 [--control]

``sweep`` builds the cell's index once and serves it at each beam, with
``rerank_k`` = beam and the configuration's repack rule
(``max(8, 1.6 x beam)`` where it has one).  ``runs`` prints one JSON line a
seed: the seed, ``correct`` and the numbers compared with their limits.
The control (``--control``) puts the configuration's lower-precision
stand-in in the program's place (``indexes/<index>.py::control``); its
runs must come out as not correct.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sweep(args) -> None:
    import torch

    from benchmark import corpus, harness, judge
    from jvector_tpu_torch import GraphConfig, build_graph

    cell = harness.load_cell(args.workload)
    cfg, dev = cell.config, torch.device("cuda")
    w = cell.traffic["wave"]
    data = corpus.make(cfg, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    queries = data.queries[torch.randperm(data.queries.shape[0], generator=g, device=dev)[:w]]
    t = time.perf_counter()
    graph, exact = build_graph(data.base, cfg["similarity"], GraphConfig(**cfg["graph"]))
    torch.cuda.synchronize()
    print(json.dumps({"workload": args.workload, "seed": args.seed, "build_s": time.perf_counter() - t}), flush=True)
    spans = harness.Spans(torch.cuda.synchronize)
    for beam in (int(b) for b in args.beams.split(",")):
        serve_cfg = dict(cfg["serve"], beam=beam, rerank_k=beam)
        if cfg["serve"]["repack_after"]:
            serve_cfg["repack_after"] = max(8, int(1.6 * beam))
        run = cell.index_module().prepare(graph, exact, data.base, dict(cfg, serve=serve_cfg), spans)
        run(queries).ids.cpu()
        t = time.perf_counter()
        res = run(queries)
        ids, scores = res.ids.cpu(), res.scores.cpu()
        secs = time.perf_counter() - t
        nums = judge.answers(data.base, queries, torch.arange(w, device=dev), ids.to(dev), scores.to(dev),
                             cfg["similarity"])
        print(json.dumps({"beam": beam, "wave_s": secs, "qps": w / secs, **nums}), flush=True)
        del run, res


def runs(args) -> None:
    from benchmark import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(args.workload, seed, args.seconds, False, control=args.control)
        print(json.dumps({"workload": args.workload, "control": args.control, "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"], "checks": r["checks"],
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()}}), flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="what", required=True)
    s = sub.add_parser("sweep")
    s.add_argument("--workload", required=True)
    s.add_argument("--seed", type=int, required=True)
    s.add_argument("--beams", required=True)
    r = sub.add_parser("runs")
    r.add_argument("--workload", required=True)
    r.add_argument("--seeds", required=True)
    r.add_argument("--seconds", type=float, required=True)
    r.add_argument("--control", action="store_true")
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        sys.exit("readings are taken on the card")
    (sweep if args.what == "sweep" else runs)(args)


if __name__ == "__main__":
    main()
