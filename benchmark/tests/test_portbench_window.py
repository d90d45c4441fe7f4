"""The measured window at a toy size on the CPU: it ends only after a whole
pass over the query order, and each wave's time reaches the harness's
``waves (s)`` line."""

import os

import pytest

from benchmark import harness


def _record(toy_root, monkeypatch, seconds):
    """Run the SQ4 cell (two waves a pass at the toy size) and keep the
    traffic kind's record."""
    cell = harness.load_cell("euclidean-sq4-batch", toy_root, os.path.join(toy_root, "benchmark"))
    kind = cell.kind_module()
    seen = []
    run = kind.run
    monkeypatch.setattr(kind, "run", lambda ctx: seen.append(run(ctx)) or seen[-1])
    r = harness.run_cell("euclidean-sq4-batch", 2**31 + 3, seconds, False, device="cpu", root=toy_root,
                         bench_dir=os.path.join(toy_root, "benchmark"))
    return r, seen[0], cell


@pytest.mark.parametrize("seconds", [0.0, 0.2, 0.7])
def test_the_window_ends_at_a_pass_boundary(toy_root, monkeypatch, seconds):
    r, rec, cell = _record(toy_root, monkeypatch, seconds)
    per_pass = cell.config["queries"]
    assert cell.config["queries"] // cell.traffic["wave"] == 2
    assert r["attempted"] % per_pass == 0 and r["attempted"] >= per_pass
    assert rec.counters["waves"] == len(rec.waves) and rec.counters["waves"] % 2 == 0
    offsets = [o for o, _ in rec.waves]
    assert offsets == sorted(offsets) and offsets[0] == 0.0
    assert all(t > 0 for _, t in rec.waves)


def test_the_wave_line_gives_quartiles_and_the_slowest_wave():
    waves = [(0.0, 0.25), (0.25, 0.27), (0.52, 0.40), (0.92, 0.26), (1.18, 0.26)]
    line = harness.wave_line(waves)
    assert line.startswith("waves (s): n 5, p10 ")
    assert "median 0.260000" in line and line.endswith("slowest 0.400000 at 0.520 of 1.440")
    assert harness.wave_line([(0.0, 0.5)]).startswith("waves (s): n 1, p10 0.500000")
    assert harness.wave_line([]) == "waves (s): none"

