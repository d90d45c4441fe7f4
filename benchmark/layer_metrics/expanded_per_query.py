"""Beam-loop expansions a query: the mean of ``SearchResult.expanded_count``
over every query of the window (a count)."""


def read(rec):
    q = rec.counters.get("queries")
    return rec.counters["expanded"] / q if q else None
