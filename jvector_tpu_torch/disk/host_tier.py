"""Host-memory tier for rerank vectors (counterpart of
``jvector_tpu/disk/host_tier.py``).

On-disk indexes keep full-resolution vectors out of the search working set
(reference ``OnDiskGraphIndex.View.getVectorInto``): the first pass runs on
the device from codes, then the rerank gathers just ``[Q, rerank_k]`` rows on
the host (often straight from the index file's memmap) and ships one dense
block to the device for exact scoring.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jvector_tpu_torch.graph.index import NEG_INF
from jvector_tpu_torch.graph.searcher import SearchResult, search
from jvector_tpu_torch.ops.similarity import SimilarityFunction, normalize_score, pairwise_raw
from jvector_tpu_torch.util.native import gather_rows


@dataclasses.dataclass
class HostVectorStore:
    """Full-resolution vectors resident in host RAM (or memmapped)."""

    vectors: np.ndarray  # [N, D], np.memmap welcome
    sim: SimilarityFunction = SimilarityFunction.EUCLIDEAN

    @staticmethod
    def from_index_file(reader, name: str, sim) -> "HostVectorStore":
        """Memmap the inline-vectors feature straight off an index file."""
        return HostVectorStore(vectors=reader.read(name, mmap=True), sim=SimilarityFunction.parse(sim))

    def rerank(self, queries: torch.Tensor, approx: SearchResult, top_k: int) -> SearchResult:
        """Exact-rescore approximate results: one host gather of
        ``[Q, K, D]`` rows, one upload, one batched product on the queries'
        device.  The approximate scores follow the same permutation as the
        returned ids."""
        dev = queries.device
        ids_t = approx.ids
        ids = ids_t.cpu().numpy()
        q, k = ids.shape
        block = gather_rows(self.vectors, np.maximum(ids, 0).reshape(-1)).reshape(q, k, -1)
        rows = torch.as_tensor(block, device=dev)
        raw = pairwise_raw(queries.float()[:, None, :], rows, self.sim)[:, 0, :]
        valid = ids_t >= 0
        exact = torch.where(valid, normalize_score(raw, self.sim), NEG_INF)
        order = torch.argsort(-exact, dim=1, stable=True)[:, :top_k]
        return SearchResult(
            ids=torch.gather(ids_t, 1, order),
            scores=torch.gather(exact, 1, order),
            visited_count=approx.visited_count,
            expanded_count=approx.expanded_count,
            reranked_count=valid.sum(dim=1, dtype=torch.int32),
            approx_scores=torch.gather(approx.scores[:, :k], 1, order),
        )


def search_with_host_rerank(
    graph,
    compressed_provider,
    host_store: HostVectorStore,
    queries: torch.Tensor,
    top_k: int,
    beam_width: int | None = None,
    rerank_k: int | None = None,
    **search_kwargs,
) -> SearchResult:
    """Two-pass search with the rerank payload on the host tier."""
    rerank_k = rerank_k or (beam_width or max(top_k, 100))
    approx = search(graph, compressed_provider, queries, top_k=rerank_k, beam_width=beam_width, **search_kwargs)
    return host_store.rerank(queries, approx, top_k)
