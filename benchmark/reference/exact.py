"""The plain reference: exact brute-force top-k and exact scores.

Plain PyTorch, with nothing of the port, of JAX or of the JAX package.  The
similarity scores are JVector's ``VectorSimilarityFunction``:
``1 / (1 + |q - x|^2)`` for euclidean, ``(1 + q.x) / 2`` for dot product,
``(1 + cos) / 2`` for cosine; higher is closer.

- :func:`topk` gives the exact top-k ids of each query over the whole base,
  in float32 with TF32 off, in blocks of queries so that it fits;
- :func:`pair_scores` gives, in float64, the exact score of given (query,
  id) pairs: what a returned score is held to;
- :func:`topk_tf32` is the control: the same search with every input
  rounded to TF32 (10 mantissa bits, what the tensor cores take from
  float32), products summed in float32.  Its answers stand in for the
  program's in the control's runs and must come out as not correct.
"""

from __future__ import annotations

import contextlib
import types

import torch

QUERY_BLOCK = 4096  # queries a block: [4096, N] float32 scores at N = 200k is 3.3 GB


@contextlib.contextmanager
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def to_score(raw: torch.Tensor, sim: str) -> torch.Tensor:
    """JVector's score from a squared distance (euclidean) or a dot /
    cosine."""
    if sim == "euclidean":
        return 1.0 / (1.0 + raw)
    return (1.0 + raw) / 2.0


def _raw(q: torch.Tensor, base: torch.Tensor, base_sq: torch.Tensor, sim: str) -> torch.Tensor:
    dots = q @ base.T
    if sim == "dot_product":
        return dots
    if sim == "cosine":
        qn = torch.linalg.vector_norm(q, dim=1, keepdim=True)
        return dots / (qn * torch.sqrt(base_sq)[None, :])
    return torch.clamp((q * q).sum(1, keepdim=True) + base_sq[None, :] - 2.0 * dots, min=0.0)


def topk(base: torch.Tensor, queries: torch.Tensor, k: int, sim: str) -> torch.Tensor:
    """Exact top-``k`` ids ``int64 [Q, k]`` of ``queries`` over ``base``."""
    with _no_tf32():
        base_sq = (base * base).sum(1)
        out = []
        for s in range(0, queries.shape[0], QUERY_BLOCK):
            raw = _raw(queries[s : s + QUERY_BLOCK], base, base_sq, sim)
            out.append(torch.topk(to_score(raw, sim), k, dim=1).indices)
        return torch.cat(out)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties to
    even), kept in float32."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    return ((b + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def topk_tf32(base: torch.Tensor, queries: torch.Tensor, k: int, sim: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The control: exact search on TF32-rounded inputs.  Returns ids
    ``int64 [Q, k]`` and their (TF32) scores ``float32 [Q, k]``."""
    b32 = round_tf32(base)
    with _no_tf32():
        base_sq = (b32 * b32).sum(1)
        ids, scores = [], []
        for s in range(0, queries.shape[0], QUERY_BLOCK):
            raw = _raw(round_tf32(queries[s : s + QUERY_BLOCK]), b32, base_sq, sim)
            top = torch.topk(to_score(raw, sim), k, dim=1)
            ids.append(top.indices)
            scores.append(top.values)
        return torch.cat(ids), torch.cat(scores)


def pair_scores(base: torch.Tensor, queries: torch.Tensor, qidx: torch.Tensor, ids: torch.Tensor, sim: str,
                block: int = 65_536) -> torch.Tensor:
    """float64 exact scores of the pairs ``(queries[qidx[i]], base[ids[i]])``
    (``qidx``, ``ids``: int64 ``[P]``, every id valid) -> ``[P]``."""
    out = []
    for s in range(0, ids.shape[0], block):
        q = queries[qidx[s : s + block]].double()
        x = base[ids[s : s + block]].double()
        if sim == "euclidean":
            raw = ((q - x) ** 2).sum(1)
        elif sim == "dot_product":
            raw = (q * x).sum(1)
        else:
            raw = (q * x).sum(1) / (torch.linalg.vector_norm(q, dim=1) * torch.linalg.vector_norm(x, dim=1))
        out.append(to_score(raw, sim))
    return torch.cat(out)


def control_search(base: torch.Tensor, cfg: dict):
    """The control in the program's place: ``run(queries)`` answers each
    wave with :func:`topk_tf32`, in the shape of the port's search result."""

    def run(queries: torch.Tensor):
        ids, scores = topk_tf32(base, queries, cfg["top_k"], cfg["similarity"])
        zeros = torch.zeros(queries.shape[0], dtype=torch.int32, device=queries.device)
        return types.SimpleNamespace(ids=ids, scores=scores, expanded_count=zeros, reranked_count=zeros)

    return run
