"""Rerank scorings a query: the mean of ``SearchResult.reranked_count``
over every query of the window (a count)."""


def read(rec):
    q = rec.counters.get("queries")
    return rec.counters["reranked"] / q if q else None
