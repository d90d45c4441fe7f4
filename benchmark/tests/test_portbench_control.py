"""`correct` comes out false for the control and for each fault a cell
can have, at a toy size on the CPU, with the harness's look for a card
skipped and the rest of a run driven as it is.

- the control: the configuration's stand-in at the precision below its
  own (``indexes/<index>.py::control``);
- a step that returns its state unchanged: the beam step (its step count
  still moves, so the loop ends);
- half of the batch left out: each wave answers its first half and
  repeats those answers for the rest;
- an answer altered where it is produced: one id of each wave's first row
  moved to the next node, its score kept.

The exchange between chips does not exist on one chip.
"""

import json
import os

import pytest
import torch

from benchmark import harness

CELLS = [w["name"] for w in json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))["workloads"]]


def _run(toy_root, cell, control=False):
    return harness.run_cell(cell, 2**32 + 11, 0.3, False, device="cpu", root=toy_root,
                            bench_dir=os.path.join(toy_root, "benchmark"), control=control)


def _failed(r):
    return [k for k, c in r["checks"].items()
            if c["value"] is None or ("min" in c and c["value"] < c["min"]) or ("max" in c and c["value"] > c["max"])]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(toy_root, cell):
    r = _run(toy_root, cell, control=True)
    assert r["correct"] is False and _failed(r)


def _step_unchanged(monkeypatch):
    from jvector_tpu_torch.graph import searcher

    monkeypatch.setattr(searcher, "_step", lambda s, *a, **k: s._replace(iters=s.iters + 1))


def _half_left_out(monkeypatch):
    from jvector_tpu_torch.graph import searcher

    orig = searcher._search_wave

    def half(graph, provider, queries, top_k, **kw):
        q, h = queries.shape[0], queries.shape[0] // 2
        r = orig(graph, provider, queries[:h], top_k, **kw)
        return r._replace(**{f: torch.cat([getattr(r, f), getattr(r, f)[: q - h]]) for f in r._fields})

    monkeypatch.setattr(searcher, "_search_wave", half)


def _answer_altered(monkeypatch):
    from jvector_tpu_torch.graph import searcher

    orig = searcher._search_wave

    def altered(graph, provider, queries, top_k, **kw):
        r = orig(graph, provider, queries, top_k, **kw)
        ids = r.ids.clone()
        ids[0, 0] = (ids[0, 0] + 1) % int(graph.num_nodes)
        return r._replace(ids=ids)

    monkeypatch.setattr(searcher, "_search_wave", altered)


@pytest.mark.parametrize("fault", [_step_unchanged, _half_left_out, _answer_altered],
                         ids=["step_unchanged", "half_left_out", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(toy_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    r = _run(toy_root, cell)
    assert r["correct"] is False and _failed(r)
