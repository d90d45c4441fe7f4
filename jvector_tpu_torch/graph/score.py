"""Score providers (counterpart of ``jvector_tpu/graph/score.py``: the
exact, SQ4, PQ-ADC, fused PQ-ADC and LUT16 (4-bit PQ) providers).

A provider has ``prepare(queries)`` -> per-wave query state and
``score(qstate, ids [Q, C])`` -> ``[Q, C]`` scores (higher = closer); the
fused providers add ``score_edges`` over their neighbor-code tables, and
the build providers add ``pairwise`` for the diversity prune.  The PQ
providers score through the K5 kernel (``ops/kernels/adc.py``), the LUT16
provider through K6 (``ops/kernels/adc16.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jvector_tpu_torch.ops.adc import build_partial_sums, partial_squared_magnitudes
from jvector_tpu_torch.ops.adc16 import lut_pairs, unpack_nibbles
from jvector_tpu_torch.ops.kernels.adc import adc_score_kernel
from jvector_tpu_torch.ops.kernels.adc16 import adc16_score_kernel
from jvector_tpu_torch.ops.similarity import SimilarityFunction, normalize_score, pairwise_raw
from jvector_tpu_torch.quantization.sq import group_dims, unpack_nibble_rows, unpack_nibble_rows_grouped


def _row_dots(qstate: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """``qstate [Q, D]`` . ``vecs [Q, R, D]`` -> ``[Q, R]``."""
    return torch.bmm(vecs, qstate.unsqueeze(-1)).squeeze(-1)


def exact_score_rows(qstate: torch.Tensor, vecs: torch.Tensor, sim: SimilarityFunction) -> torch.Tensor:
    """Exact scores from already-gathered rows: qstate ``[Q, D]``,
    vecs ``[Q, R, D]`` -> ``[Q, R]``.  The build gathers each candidate row
    once and derives both the rescore and the prune matrix from it."""
    vecs = vecs.float()
    dots = _row_dots(qstate, vecs)
    if sim == SimilarityFunction.DOT_PRODUCT:
        raw = dots
    elif sim == SimilarityFunction.COSINE:
        vn = torch.sqrt(torch.sum(vecs * vecs, dim=-1))
        raw = dots / torch.clamp(vn, min=1e-30)  # qstate already normalized
    else:
        q2 = torch.sum(qstate * qstate, dim=-1)[:, None]
        v2 = torch.sum(vecs * vecs, dim=-1)
        raw = torch.clamp(q2 + v2 - 2.0 * dots, min=0.0)
    return normalize_score(raw, sim)


def exact_pairwise_rows(va: torch.Tensor, sim: SimilarityFunction) -> torch.Tensor:
    """All-pairs similarity from gathered rows: ``[B, C, D]`` -> ``[B, C, C]``.

    The dot-product inputs are rounded to bfloat16, as the JAX package does
    by default; the products of two bf16 values are exact in float32, so
    the float32 matrix product here differs from the JAX one only in the
    order of the float32 sums.  The squared norms stay float32.  The matrix
    only feeds the prune's dominance comparisons.
    """
    va = va.float()
    vd = va.to(torch.bfloat16).float()
    dots = vd @ vd.transpose(1, 2)
    if sim == SimilarityFunction.DOT_PRODUCT:
        raw = dots
    elif sim == SimilarityFunction.COSINE:
        n2 = torch.sqrt(torch.sum(va * va, dim=-1))
        raw = dots / torch.clamp(n2[:, :, None] * n2[:, None, :], min=1e-30)
    else:
        a2 = torch.sum(va * va, dim=-1)
        raw = torch.clamp(a2[:, :, None] + a2[:, None, :] - 2.0 * dots, min=0.0)
    return normalize_score(raw, sim)


@dataclasses.dataclass(frozen=True)
class ExactScoreProvider:
    """Full-precision scoring over device-resident vectors ``[N, D]``.

    Reference: ``BuildScoreProvider.randomAccessScoreProvider`` +
    ``DefaultSearchScoreProvider.exact``.
    """

    vectors: torch.Tensor  # [N, D] float32 (bfloat16 storage is promoted)
    sim: SimilarityFunction = SimilarityFunction.EUCLIDEAN

    def prepare(self, queries: torch.Tensor) -> torch.Tensor:
        queries = queries.float()
        if self.sim == SimilarityFunction.COSINE:
            n = torch.sqrt(torch.sum(queries * queries, dim=-1, keepdim=True))
            return queries / torch.clamp(n, min=1e-30)
        return queries

    def score(self, qstate: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """qstate ``[Q, D]``, ids ``[Q, R]`` (>= 0) -> ``[Q, R]``."""
        return exact_score_rows(qstate, self.vectors[ids.long()], self.sim)

    def pairwise(self, ids_a: torch.Tensor, ids_b: torch.Tensor) -> torch.Tensor:
        """Batched all-pairs: ids_a ``[B, Ca]``, ids_b ``[B, Cb]`` -> ``[B, Ca, Cb]``."""
        va = self.vectors[ids_a.long()].float()
        vb = self.vectors[ids_b.long()].float()
        return normalize_score(pairwise_raw(va, vb, self.sim), self.sim)


@dataclasses.dataclass(frozen=True)
class SQ4ScoreProvider:
    """Edge-fused 4-bit scalar-quantized scoring.

    - ``codes_packed [N, MP]`` uint8 — entry / arbitrary-id scoring, or
      None to read code rows from ``codes_aug`` (the larger-than-memory
      build keeps one device copy of the codes)
    - ``fused_packed`` uint8 — each node's neighbors' codes, slot-aligned
      with its adjacency row: ``[N, R*MP]`` when serving, or the build's
      ``[N, T, 128]`` table (``T = R*MP/128``); ``[N, 0]`` (no fused
      tables) makes the search score plain code rows
    - ``fused_w2`` — the neighbors' per-node constants: ``[N, R]`` float32
      when serving, or the build's packed ``[N/8, 8, 128]`` int32 table with
      float32 bits in lanes ``[0:R]``
    - ``codes_aug [N, MP+4]`` uint8 — codes plus the sim-appropriate
      per-node constant as 4 little-endian bytes (one gather per score), or
      None to gather codes and constants separately

    The build updates ``fused_packed`` and ``fused_w2`` in place between
    waves (see ``graph/builder.py``), where the JAX package donated them.
    """

    codes_packed: torch.Tensor | None  # [N, MP] uint8
    node_w2: torch.Tensor  # [N] float32
    node_norm2: torch.Tensor  # [N] float32
    fused_packed: torch.Tensor
    fused_w2: torch.Tensor
    scale: torch.Tensor  # [D_pad] float32
    offset: torch.Tensor  # [D_pad] float32
    codes_aug: torch.Tensor | None = None
    sim: SimilarityFunction = SimilarityFunction.EUCLIDEAN

    @property
    def supports_fused(self) -> bool:
        return self.fused_packed.numel() > 0

    @property
    def mp(self) -> int:
        """Packed code bytes per node (with or without a codes_packed tensor)."""
        if self.codes_packed is not None:
            return self.codes_packed.shape[1]
        return self.codes_aug.shape[1] - 4

    def _code_rows(self, ids: torch.Tensor) -> torch.Tensor:
        """Packed code rows for arbitrary ids (from codes_aug if need be)."""
        if self.codes_packed is not None:
            return self.codes_packed[ids]
        return self.codes_aug[ids][..., : self.mp]

    def _codes_array(self) -> torch.Tensor:
        """The whole ``[N, MP]`` codes tensor (a slice copy when aug-backed:
        for saves, never per wave)."""
        if self.codes_packed is not None:
            return self.codes_packed
        return self.codes_aug[:, : self.mp].contiguous()

    @property
    def padded_dim(self) -> int:
        return self.scale.shape[0]

    def prepare(self, queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Query state: FMA vector ``u [Q, D]`` in grouped dim order plus
        the constant ``c0 [Q]``."""
        q = queries.float()
        d = q.shape[-1]
        if d < self.padded_dim:
            q = torch.nn.functional.pad(q, (0, self.padded_dim - d))
        if self.sim == SimilarityFunction.EUCLIDEAN:
            qb = q - self.offset
            u = -2.0 * self.scale * qb
            return group_dims(u), torch.sum(qb * qb, dim=-1)
        if self.sim == SimilarityFunction.COSINE:
            n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
            qn = q / torch.clamp(n, min=1e-30)
            return group_dims(qn * self.scale), torch.sum(qn * self.offset, dim=-1)
        return group_dims(q * self.scale), torch.sum(q * self.offset, dim=-1)

    def _finish(self, acc, c0, w2, norm2):
        """acc = sum u*k over dims; combine with the constants per similarity."""
        if self.sim == SimilarityFunction.EUCLIDEAN:
            raw = torch.clamp(acc + c0[:, None] + w2, min=0.0)
        elif self.sim == SimilarityFunction.COSINE:
            raw = (acc + c0[:, None]) / torch.clamp(torch.sqrt(norm2), min=1e-30)
        else:
            raw = acc + c0[:, None]
        return normalize_score(raw, self.sim)

    def score(self, qstate, ids: torch.Tensor) -> torch.Tensor:
        """ids ``[Q, C]`` (>= 0) -> scores ``[Q, C]``."""
        u, c0 = qstate
        ids = ids.long()
        if self.codes_aug is not None:
            mp = self.mp
            rows = self.codes_aug[ids]  # one gather: codes + packed constant
            k = unpack_nibble_rows_grouped(rows[..., :mp]).float()
            const = rows[..., mp : mp + 4].contiguous().view(torch.float32)[..., 0]
            return self._finish(_row_dots(u, k), c0, const, const)
        k = unpack_nibble_rows_grouped(self._code_rows(ids)).float()
        return self._finish(_row_dots(u, k), c0, self.node_w2[ids], self.node_norm2[ids])

    def score_edges(self, qstate, node_ids: torch.Tensor) -> torch.Tensor:
        """``[Q]`` or ``[Q, E]`` expanded nodes (>= 0) -> neighbor scores ``[Q, E*R]``."""
        u, c0 = qstate
        q = node_ids.shape[0]
        mp = self.mp
        nid = node_ids.long()
        rows = self.fused_packed[nid]  # [Q, (E,) R*MP] or [Q, (E,) T, 128]
        if self.fused_w2.dim() == 3:
            # the build's packed [N/8, 8, 128] int32 table (f32 bits in
            # lanes [0:R]): one 512-byte physical-row gather per node
            fp = self.fused_packed.shape
            r = (fp[1] * fp[2] if len(fp) == 3 else fp[1]) // mp
            w2 = self.fused_w2[nid >> 3, nid & 7][..., :r].view(torch.float32)
        else:
            w2 = self.fused_w2[nid]
        rows = rows.reshape(q, -1, mp)  # [Q, E*R, MP]
        w2 = w2.reshape(q, -1)
        k = unpack_nibble_rows_grouped(rows).float()
        return self._finish(_row_dots(u, k), c0, w2, w2)

    def decode(self, ids: torch.Tensor) -> torch.Tensor:
        k = unpack_nibble_rows(self._code_rows(ids.long())).float()
        return k * self.scale + self.offset

    def pairwise(self, ids_a: torch.Tensor, ids_b: torch.Tensor) -> torch.Tensor:
        """All-pairs on dequantized vectors (one decode per side)."""
        a = self.decode(ids_a)
        b = a if ids_a is ids_b else self.decode(ids_b)
        return normalize_score(pairwise_raw(a, b, self.sim), self.sim)


def sq4_aug_rows(codes_packed: torch.Tensor, const: torch.Tensor) -> torch.Tensor:
    """Codes + per-node constant as one gatherable row ``[N, MP+4]`` uint8
    (the constant's float32 bits, little-endian)."""
    b4 = const.float().contiguous().view(torch.uint8).reshape(-1, 4)
    return torch.cat([codes_packed, b4], dim=-1)


def build_fused_sq4(
    neighbors: torch.Tensor,
    codes_packed: torch.Tensor,
    node_w2: torch.Tensor,
    chunk: int = 65_536,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused SQ4 serving layout: ``(fused_packed [N, R*MP] uint8,
    fused_w2 [N, R] float32)``; -1 padding slots get code 0 / constant 0."""
    n, r = neighbors.shape
    mp = codes_packed.shape[1]
    out = torch.zeros((n, r * mp), dtype=torch.uint8, device=neighbors.device)
    out_w2 = torch.zeros((n, r), dtype=torch.float32, device=neighbors.device)
    for start in range(0, n, chunk):
        blk = neighbors[start : start + chunk]
        ok = blk >= 0
        safe = torch.clamp(blk, min=0).long()
        gathered = torch.where(ok[..., None], codes_packed[safe], 0)
        out[start : start + blk.shape[0]] = gathered.reshape(blk.shape[0], -1)
        out_w2[start : start + blk.shape[0]] = torch.where(ok, node_w2[safe], 0.0)
    return out, out_w2


def build_fused_sq4_host(
    neighbors: np.ndarray,  # [B, R] int32, -1 padded
    codes_packed: np.ndarray,  # [N, MP] uint8
    node_w2: np.ndarray,  # [N] float32
) -> tuple[np.ndarray, np.ndarray]:
    """Numpy twin of :func:`build_fused_sq4` for saves from host memory:
    the larger-than-memory save streams the fused layout into the file,
    a pure gather of host-resident codes."""
    safe = np.maximum(neighbors, 0)
    ok = neighbors >= 0
    gathered = codes_packed[safe]  # [B, R, MP]
    gathered[~ok] = 0
    w2 = np.where(ok, node_w2[safe], np.float32(0.0)).astype(np.float32)
    return gathered.reshape(neighbors.shape[0], -1), w2


@dataclasses.dataclass(frozen=True)
class ADCScoreProvider:
    """PQ compressed scoring through per-query ADC lookup tables.

    Reference: ``PQVectors.precomputedScoreFunctionFor`` -> ``PQDecoder``
    (LUT built once per query, gather + sum per candidate) and
    ``BuildScoreProvider.pqBuildScoreProvider``.
    """

    codes: torch.Tensor  # [N, M] uint8
    codebooks: torch.Tensor  # [M, K, S] float32
    center: torch.Tensor | None  # [D_pad] global centering vector or None
    sim: SimilarityFunction = SimilarityFunction.EUCLIDEAN

    @property
    def padded_dim(self) -> int:
        m, _, s = self.codebooks.shape
        return m * s

    def prepare(self, queries: torch.Tensor) -> torch.Tensor:
        """LUTs ``[Q, M, K]`` (the ``calculatePartialSums`` step)."""
        q = queries.float()
        if q.shape[-1] < self.padded_dim:
            q = torch.nn.functional.pad(q, (0, self.padded_dim - q.shape[-1]))
        if self.center is not None:
            q = q - self.center
        if self.sim == SimilarityFunction.COSINE:
            n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
            return build_partial_sums(q / torch.clamp(n, min=1e-30), self.codebooks, SimilarityFunction.DOT_PRODUCT)
        return build_partial_sums(q, self.codebooks, self.sim)

    def _score_codes(self, luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        """luts ``[Q, M, K]``, codes ``[Q, C, M]`` -> scores ``[Q, C]`` (K5)."""
        raw = adc_score_kernel(luts, codes)
        if self.sim == SimilarityFunction.COSINE:
            c2 = partial_squared_magnitudes(self.codebooks)  # one table for every query
            mag = adc_score_kernel(c2[None].expand(luts.shape), codes)
            raw = raw / torch.clamp(torch.sqrt(mag), min=1e-30)
        return normalize_score(raw, self.sim)

    def score(self, luts: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """ids ``[Q, C]`` (>= 0) -> ``[Q, C]``."""
        return self._score_codes(luts, self.codes[ids.long()])

    def decode_centered(self, ids: torch.Tensor) -> torch.Tensor:
        """Codes -> padded, still-centered vectors ``[..., M*S]``
        (``ProductQuantization.decodeCentered``)."""
        m = self.codebooks.shape[0]
        parts = self.codebooks[torch.arange(m, device=ids.device), self.codes[ids.long()].long()]
        return parts.reshape(*ids.shape, -1)

    def score_nodes(self, node_ids: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Code-to-code scores: node_ids ``[B]``, ids ``[B, R]`` -> ``[B, R]``.
        Subspaces are independent, so the sum of per-subspace centroid
        measures equals the measure between the decoded vectors."""
        a = self.decode_centered(node_ids)[:, None, :]
        b = self.decode_centered(ids)
        return normalize_score(pairwise_raw(a, b, self.sim)[:, 0, :], self.sim)

    def pairwise(self, ids_a: torch.Tensor, ids_b: torch.Tensor) -> torch.Tensor:
        """Batched all-pairs code-to-code ``[B, Ca, Cb]`` (one decode per side)."""
        a = self.decode_centered(ids_a)
        b = a if ids_a is ids_b else self.decode_centered(ids_b)
        return normalize_score(pairwise_raw(a, b, self.sim), self.sim)


@dataclasses.dataclass(frozen=True)
class FusedADCScoreProvider:
    """Edge-fused ADC: each node's row holds its neighbors' PQ codes,
    slot-aligned with its adjacency row, so one row gather scores a whole
    expansion (reference ``FusedPQ`` + ``FusedPQDecoder``).  ``codes``
    remain for entry, hierarchy and arbitrary-id scoring."""

    codes: torch.Tensor  # [N, M] uint8
    fused_codes: torch.Tensor  # [N, R, M] uint8, aligned with the graph's neighbors
    codebooks: torch.Tensor  # [M, K, S]
    center: torch.Tensor | None
    sim: SimilarityFunction = SimilarityFunction.EUCLIDEAN

    @property
    def supports_fused(self) -> bool:
        return True

    def _plain(self) -> ADCScoreProvider:
        return ADCScoreProvider(codes=self.codes, codebooks=self.codebooks, center=self.center, sim=self.sim)

    def prepare(self, queries: torch.Tensor) -> torch.Tensor:
        return self._plain().prepare(queries)

    def score(self, luts: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return self._plain().score(luts, ids)

    def score_edges(self, luts: torch.Tensor, node_ids: torch.Tensor) -> torch.Tensor:
        """All neighbors of ``node_ids`` ``[Q]`` or ``[Q, E]`` -> ``[Q, E*R]``:
        one contiguous ``R*M``-byte row per expansion."""
        codes = self.fused_codes[node_ids.long()]
        return self._plain()._score_codes(luts, codes.reshape(node_ids.shape[0], -1, codes.shape[-1]))


def build_fused_codes(neighbors: torch.Tensor, codes: torch.Tensor, chunk: int = 65_536) -> torch.Tensor:
    """Each node's neighbors' codes next to its adjacency row ``[N, R, M]``
    (reference ``FusedPQ.writeInline``); -1 padding slots get code 0."""
    n, r = neighbors.shape
    out = torch.zeros((n, r, codes.shape[1]), dtype=torch.uint8, device=neighbors.device)
    for start in range(0, n, chunk):
        blk = neighbors[start : start + chunk]
        gathered = codes[torch.clamp(blk, min=0).long()]
        out[start : start + blk.shape[0]] = torch.where((blk >= 0)[..., None], gathered, 0)
    return out


@dataclasses.dataclass(frozen=True)
class LUT16ScoreProvider:
    """Edge-fused 4-bit PQ scoring: K = 16 centroids per subspace, two codes
    a byte, and twice the subspaces of 8-bit PQ for the same bits a vector,
    so each query's lookup tables are 16x smaller (the trade of SCANN's
    LUT16; the reference's ``FusedPQ`` pins K = 256).

    Layouts (see :mod:`jvector_tpu_torch.ops.adc16`):

    - ``codes_packed [N, MP]`` uint8 (MP = M/2 packed bytes): entry, rerank
      pool and arbitrary-id scoring;
    - ``fused_packed [N, MP, R]`` uint8: each node's neighbors' packed codes,
      subspace-major and slot-aligned with its adjacency row (or None when
      only :meth:`score` is used).
    """

    codes_packed: torch.Tensor  # [N, MP] uint8
    fused_packed: torch.Tensor | None  # [N, MP, R] uint8
    codebooks: torch.Tensor  # [M, 16, S] float32
    center: torch.Tensor | None  # [M*S] or None
    sim: SimilarityFunction = SimilarityFunction.EUCLIDEAN

    @property
    def exact(self) -> bool:
        return False

    @property
    def supports_fused(self) -> bool:
        return True

    @property
    def padded_dim(self) -> int:
        m, _, s = self.codebooks.shape
        return m * s

    def prepare(self, queries: torch.Tensor) -> torch.Tensor:
        """Paired LUTs ``[Q, MP, 32]``."""
        q = queries.float()
        if q.shape[-1] < self.padded_dim:
            q = torch.nn.functional.pad(q, (0, self.padded_dim - q.shape[-1]))
        if self.center is not None:
            q = q - self.center
        if self.sim == SimilarityFunction.COSINE:
            n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
            luts = build_partial_sums(q / torch.clamp(n, min=1e-30), self.codebooks, SimilarityFunction.DOT_PRODUCT)
        else:
            luts = build_partial_sums(q, self.codebooks, self.sim)
        return lut_pairs(luts)

    def _norm(self, raw: torch.Tensor, codes_t: torch.Tensor) -> torch.Tensor:
        """COSINE divides by the candidates' centroid norms: a second K6
        call on one shared table of squared norms (query stride 0)."""
        if self.sim == SimilarityFunction.COSINE:
            c2 = lut_pairs(partial_squared_magnitudes(self.codebooks)[None])  # [1, MP, 32]
            mag = adc16_score_kernel(c2.expand(codes_t.shape[0], -1, -1), codes_t)
            raw = raw / torch.clamp(torch.sqrt(mag), min=1e-30)
        return normalize_score(raw, self.sim)

    def _score_codes(self, luts: torch.Tensor, codes_t: torch.Tensor) -> torch.Tensor:
        """luts ``[Q, MP, 32]``, codes ``[Q, MP, C]`` -> scores ``[Q, C]`` (K6)."""
        codes_t = codes_t.contiguous()
        return self._norm(adc16_score_kernel(luts, codes_t), codes_t)

    def score(self, luts: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """ids ``[Q, C]`` (>= 0) -> scores ``[Q, C]`` (entry, hierarchy, rerank pool)."""
        return self._score_codes(luts, self.codes_packed[ids.long()].transpose(1, 2))

    def score_edges(self, luts: torch.Tensor, node_ids: torch.Tensor) -> torch.Tensor:
        """``[Q]`` or ``[Q, E]`` expanded nodes -> neighbor scores ``[Q, E*R]``,
        column ``e*R + r`` for slot r of expansion e (the searcher's order)."""
        q = node_ids.shape[0]
        rows = self.fused_packed[node_ids.long()]  # [Q, (E,) MP, R]
        if rows.dim() == 4:
            rows = rows.permute(0, 2, 1, 3).reshape(q, rows.shape[2], -1)
        return self._score_codes(luts, rows)

    # -- build-time surface (decode origin, ADC against candidates) --------

    def decode_centered(self, ids: torch.Tensor) -> torch.Tensor:
        """Codes -> padded, still-centered vectors ``[..., M*S]``."""
        codes = unpack_nibbles(self.codes_packed[ids.long()]).long()
        m = self.codebooks.shape[0]
        return self.codebooks[torch.arange(m, device=ids.device), codes].reshape(*ids.shape, -1)

    def score_nodes(self, node_ids: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Code-to-code scores: node_ids ``[B]``, ids ``[B, R]`` -> ``[B, R]``,
        through LUTs built from the decoded origins."""
        origins = self.decode_centered(node_ids)
        sim = self.sim
        if sim == SimilarityFunction.COSINE:
            n = torch.sqrt(torch.sum(origins * origins, dim=-1, keepdim=True))
            origins = origins / torch.clamp(n, min=1e-30)
            sim = SimilarityFunction.DOT_PRODUCT
        return self.score(lut_pairs(build_partial_sums(origins, self.codebooks, sim)), ids)

    def pairwise(self, ids_a: torch.Tensor, ids_b: torch.Tensor) -> torch.Tensor:
        """Batched all-pairs ``[B, Ca, Cb]`` (one LUT per row of ``ids_a``)."""
        b, ca = ids_a.shape
        cb = ids_b.shape[1]
        flat = self.score_nodes(ids_a.reshape(-1), ids_b[:, None].expand(b, ca, cb).reshape(b * ca, cb))
        return flat.reshape(b, ca, cb)


def build_fused_codes_lut16(neighbors: torch.Tensor, codes_packed: torch.Tensor, chunk: int = 65_536) -> torch.Tensor:
    """Each node's neighbors' packed 4-bit codes, transposed next to its
    adjacency row: ``out[n, j, r] = codes_packed[nbr[n, r], j]`` ``[N, MP, R]``
    uint8; -1 padding slots get code 0 (masked by the id at search time)."""
    n, r = neighbors.shape
    out = torch.zeros((n, codes_packed.shape[1], r), dtype=torch.uint8, device=neighbors.device)
    for start in range(0, n, chunk):
        blk = neighbors[start : start + chunk]
        gathered = codes_packed[torch.clamp(blk, min=0).long()].transpose(1, 2)  # [B, MP, R]
        out[start : start + blk.shape[0]] = torch.where((blk >= 0)[:, None, :], gathered, 0)
    return out
