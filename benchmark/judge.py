"""What decides ``correct``: the program's answers held to the reference.

Every answer row the window produced (a query's top-k ids and scores) is
compared, after the window has closed and the program's state is freed:

- ``recall``: the share of the exact top-k (``reference.exact.topk``) that
  the returned ids hold, over all rows; held to the configuration's floor;
- ``score_gap``: the widest relative gap between a returned score and the
  float64 exact score of the same (query, id) pair
  (``reference.exact.pair_scores``); held to the configuration's limit,
  which the program's readings and its control's set;
- ``bad_ids``: returned ids outside ``[0, n)`` or repeated within a row;
  held to 0.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import exact

ROW_BLOCK = 262_144  # answer rows a block in the id comparisons


def _bad_mask(ids: torch.Tensor, n: int) -> torch.Tensor:
    out_of_range = (ids < 0) | (ids >= n)
    srt = torch.sort(ids, dim=1).values
    dup = torch.zeros_like(out_of_range)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]  # positions of the sorted row, counted alike
    return out_of_range | dup


def answers(base: torch.Tensor, queries: torch.Tensor, qidx: torch.Tensor, ids: torch.Tensor,
            scores: torch.Tensor, sim: str) -> dict:
    """Numbers for answer rows ``ids`` / ``scores`` ``[M, k]`` of queries
    ``queries[qidx]`` over ``base`` (all on one device).  Returns
    ``recall``, ``score_gap``, ``bad_ids`` and ``bad_rows``."""
    n, k = base.shape[0], ids.shape[1]
    ids = ids.long()
    qidx = qidx.long()
    used = torch.unique(qidx)
    table = torch.full((queries.shape[0], k), -1, dtype=torch.long, device=base.device)
    table[used] = exact.topk(base, queries[used], k, sim)
    hits = bad = bad_rows = 0
    for s in range(0, ids.shape[0], ROW_BLOCK):
        blk = ids[s : s + ROW_BLOCK]
        gt = table[qidx[s : s + ROW_BLOCK]]
        badm = _bad_mask(blk, n)
        hit = (blk[:, :, None] == gt[:, None, :]).any(-1) & ~badm
        hits += int(hit.sum())
        bad += int(badm.sum())
        bad_rows += int(badm.any(1).sum())
    valid = (ids >= 0) & (ids < n)
    q_flat = qidx[:, None].expand_as(ids)[valid]
    i_flat = ids[valid]
    keys, inv = torch.unique(q_flat * n + i_flat, return_inverse=True)
    ref = exact.pair_scores(base, queries, keys // n, keys % n, sim)[inv]
    got = scores.double()[valid]
    gap = float(((got - ref).abs() / ref.abs()).max()) if got.numel() else float("inf")
    return {"recall": hits / ids.numel(), "score_gap": gap, "bad_ids": bad, "bad_rows": bad_rows}


def checks(numbers: dict, limits: dict) -> dict:
    """Each number compared beside its limit, in the order printed."""
    return {
        "recall": {"value": numbers["recall"], "min": limits["recall_min"]},
        "score_gap": {"value": numbers["score_gap"], "max": limits["score_gap_max"]},
        "bad_ids": {"value": numbers["bad_ids"], "max": limits["bad_ids_max"]},
    }


def passed(chk: dict) -> bool:
    """Every number within its limit; a number that is not finite fails."""
    return all(math.isfinite(c["value"]) and ("min" not in c or c["value"] >= c["min"])
               and ("max" not in c or c["value"] <= c["max"]) for c in chk.values())
