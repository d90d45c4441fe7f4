"""Versioned single-file index container (counterpart of
``jvector_tpu/disk/format.py``; the byte layout is the shared interface of
the two packages: a file either one writes loads in the other).

Layout (little-endian)::

    [8B  magic "JVTPU\\x00" + u16 version]
    [array blobs, each 64-byte aligned]
    [JSON header]
    [u64 header offset][u32 header length][4B footer magic "JVBD"]

Every blob carries a CRC32.  Writers may *reserve* an array extent up front
and fill rows positionally later (the larger-than-memory build).  Version
history, as in the JAX package: 1 the initial container, 2 adds per-level
``graph/L{l}/node_ids`` and ``num_levels`` (additive), 3 the paired L0 layout
``graph/L0/neighbors_paired [N/2, 2*Rp]`` (meta ``l0_layout = "paired"``,
``l0_row_cap = R``).  A file stamps the lowest version that can read it.

The container is numpy on the host; :meth:`OnDiskIndex.graph_to_device`
and :meth:`OnDiskIndex.to_device` put the searchable pieces on a torch
device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import zlib

import numpy as np
import torch

from jvector_tpu_torch.graph.index import NEG_INF, GraphIndex, GraphLayer
from jvector_tpu_torch.util.device import resolve_device

MAGIC = b"JVTPU\x00"
FOOTER_MAGIC = b"JVBD"
VERSION = 3
WRITE_VERSION_DEFAULT = 2
_ALIGN = 64


class FeatureId:
    """Feature names (reference ``FeatureId`` enum)."""

    INLINE_VECTORS = "inline_vectors"
    FUSED_PQ = "fused_pq"
    NVQ_VECTORS = "nvq_vectors"
    SEPARATED_VECTORS = "separated_vectors"
    SEPARATED_NVQ = "separated_nvq"
    PQ_CODES = "pq_codes"  # sidecar compressed vectors (reference PQVectors file)
    BQ_CODES = "bq_codes"
    FUSED_SQ4 = "fused_sq4"  # 4-bit scalar-quantized fused codes

    ALL = (INLINE_VECTORS, FUSED_PQ, NVQ_VECTORS, SEPARATED_VECTORS, SEPARATED_NVQ, PQ_CODES, BQ_CODES, FUSED_SQ4)


@dataclasses.dataclass
class _ArrayEntry:
    dtype: str
    shape: tuple[int, ...]
    offset: int
    nbytes: int
    crc32: int | None


def _np(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class IndexFileWriter:
    """Streaming writer: add arrays (whole, or reserved and row-filled), then
    close.  Appends are sequential; reserved extents are written
    positionally."""

    def __init__(self, path: str | os.PathLike, version: int | None = None):
        self.path = str(path)
        self.version = WRITE_VERSION_DEFAULT if version is None else version
        if not (1 <= self.version <= VERSION):
            raise ValueError(f"unsupported write version {version}")
        self._f = open(self.path, "wb+")
        self._f.write(MAGIC + struct.pack("<H", self.version))
        self._arrays: dict[str, _ArrayEntry] = {}
        self._meta: dict = {}
        self._closed = False

    def _align(self) -> int:
        pos = self._f.seek(0, os.SEEK_END)
        pad = (-pos) % _ALIGN
        if pad:
            self._f.write(b"\x00" * pad)
        return pos + pad

    def add_array(self, name: str, arr) -> None:
        arr = np.ascontiguousarray(_np(arr))
        off = self._align()
        data = arr.tobytes()
        self._f.write(data)
        self._arrays[name] = _ArrayEntry(
            dtype=arr.dtype.str, shape=tuple(arr.shape), offset=off, nbytes=len(data),
            crc32=zlib.crc32(data) & 0xFFFFFFFF,
        )

    def reserve_array(self, name: str, shape: tuple[int, ...], dtype) -> None:
        """Reserve a zero-filled extent to be row-filled with :meth:`write_rows`."""
        dt = np.dtype(dtype)
        off = self._align()
        nbytes = int(np.prod(shape)) * dt.itemsize
        self._f.truncate(off + nbytes)
        self._f.seek(off + nbytes)
        self._arrays[name] = _ArrayEntry(dtype=dt.str, shape=tuple(shape), offset=off, nbytes=nbytes, crc32=None)

    def write_rows(self, name: str, start_row: int, rows) -> None:
        """Positionally fill rows of a reserved array."""
        e = self._arrays[name]
        dt = np.dtype(e.dtype)
        rows = np.ascontiguousarray(_np(rows), dtype=dt)
        row_elems = int(np.prod(e.shape[1:])) if len(e.shape) > 1 else 1
        if rows.shape[1:] != e.shape[1:]:
            raise ValueError(f"row shape mismatch for {name}: {rows.shape[1:]} != {e.shape[1:]}")
        end = self._f.tell()
        self._f.seek(e.offset + start_row * row_elems * dt.itemsize)
        self._f.write(rows.tobytes())
        self._f.seek(max(end, self._f.tell()))

    def set_meta(self, **kv) -> None:
        self._meta.update(kv)

    def state_dict(self) -> dict:
        """JSON-able snapshot (arrays so far, pending meta, file size) from
        which an interrupted incremental build can :meth:`resume` the file."""
        self._f.flush()
        os.fsync(self._f.fileno())
        return {
            "arrays": {k: dataclasses.asdict(v) for k, v in self._arrays.items()},
            "meta": dict(self._meta),
            "file_size": self._f.seek(0, os.SEEK_END),
        }

    @classmethod
    def resume(cls, path: str | os.PathLike, state: dict) -> "IndexFileWriter":
        """Reopen a partially written (footer-less) file from :meth:`state_dict`.

        Bytes past the snapshot's size are cut off; positional row writes
        are idempotent.  A missing file, or one shorter than the snapshot, is
        refused rather than zero-extended.
        """
        if not os.path.exists(path):
            raise ValueError(f"{path}: missing (cannot resume a deleted file)")
        if os.path.getsize(path) < state["file_size"]:
            raise ValueError(
                f"{path}: shorter than the snapshot ({os.path.getsize(path)} < {state['file_size']} bytes); "
                "refusing to zero-extend"
            )
        w = cls.__new__(cls)
        w.path = str(path)
        w._f = open(w.path, "rb+")
        if w._f.read(6) != MAGIC:
            w._f.close()
            raise ValueError(f"{path}: bad magic (not a jvtpu file)")
        w.version = struct.unpack("<H", w._f.read(2))[0]
        w._f.truncate(state["file_size"])
        w._f.seek(0, os.SEEK_END)
        w._arrays = {k: _ArrayEntry(v["dtype"], tuple(v["shape"]), v["offset"], v["nbytes"], v["crc32"])
                     for k, v in state["arrays"].items()}
        w._meta = dict(state["meta"])
        w._closed = False
        return w

    def close(self) -> None:
        if self._closed:
            return
        header = {
            "version": self.version,
            "meta": self._meta,
            "arrays": {k: dataclasses.asdict(v) for k, v in self._arrays.items()},
        }
        hoff = self._align()
        hbytes = json.dumps(header).encode()
        self._f.write(hbytes)
        self._f.write(struct.pack("<QI", hoff, len(hbytes)))
        self._f.write(FOOTER_MAGIC)
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class IndexFileReader:
    """Memmap-backed reader."""

    def __init__(self, path: str | os.PathLike):
        self.path = str(path)
        size = os.path.getsize(self.path)
        with open(self.path, "rb") as f:
            head = f.read(8)
            if head[:6] != MAGIC:
                raise ValueError(f"{path}: bad magic")
            self.version = struct.unpack("<H", head[6:8])[0]
            if self.version > VERSION:
                raise ValueError(f"{path}: unsupported version {self.version}")
            if size < 24:
                raise ValueError(f"{path}: bad footer (truncated file?)")
            f.seek(size - 16)
            tail = f.read(16)
            if tail[12:] != FOOTER_MAGIC:
                raise ValueError(f"{path}: bad footer (truncated file?)")
            hoff, hlen = struct.unpack("<QI", tail[:12])
            f.seek(hoff)
            header = json.loads(f.read(hlen))
        self.meta: dict = header["meta"]
        self._arrays = {k: _ArrayEntry(v["dtype"], tuple(v["shape"]), v["offset"], v["nbytes"], v["crc32"])
                        for k, v in header["arrays"].items()}

    def array_names(self) -> list[str]:
        return list(self._arrays)

    def has_array(self, name: str) -> bool:
        return name in self._arrays

    def read(self, name: str, mmap: bool = True, verify: bool = False) -> np.ndarray:
        e = self._arrays[name]
        if mmap and not verify:
            return np.memmap(self.path, dtype=np.dtype(e.dtype), mode="r", offset=e.offset, shape=e.shape)
        if verify and e.crc32 is not None:
            from jvector_tpu_torch.util.native import crc32_file

            if crc32_file(self.path, e.offset, e.nbytes) != e.crc32:
                raise ValueError(f"{self.path}:{name}: CRC mismatch")
        with open(self.path, "rb") as f:
            f.seek(e.offset)
            data = f.read(e.nbytes)
        if len(data) != e.nbytes:
            raise ValueError(f"{self.path}:{name}: short read (truncated file?)")
        return np.frombuffer(data, dtype=np.dtype(e.dtype)).reshape(e.shape)


# ---------------------------------------------------------------------------
# Graph-level save / load
# ---------------------------------------------------------------------------


def unpack_paired_neighbors(paired: np.ndarray, n_cap: int, r: int) -> np.ndarray:
    """v3 paired ``[N/2, 2*Rp]`` blob -> plain ``[N_cap, R]`` (host)."""
    n2, lanes = paired.shape
    return np.ascontiguousarray(np.asarray(paired).reshape(n2 * 2, lanes // 2)[:n_cap, :r])


def _read_l0_neighbors(reader: IndexFileReader, mmap: bool = False) -> np.ndarray:
    """Version-dispatching L0 adjacency read: ``[N, R]`` from either layout
    (``mmap=True`` keeps plain files zero-copy; paired files unpack)."""
    if reader.has_array("graph/L0/neighbors"):
        out = reader.read("graph/L0/neighbors", mmap=mmap)
        return out if mmap else np.asarray(out)
    if reader.meta.get("l0_layout") == "paired":
        paired = reader.read("graph/L0/neighbors_paired")
        n_cap = reader.read("graph/L0/counts").shape[0]
        return unpack_paired_neighbors(paired, n_cap, reader.meta["l0_row_cap"])
    raise ValueError(f"{reader.path}: no L0 adjacency array")


def pack_adjacency_pairs_host(neighbors: np.ndarray, r_pad: int) -> np.ndarray:
    """``[N, R]`` int32 (-1 padded) -> paired ``[N/2, 2*r_pad]`` (the v3 L0
    layout; numpy copy of the JAX package's ``device_tier`` helper).  An odd
    N gets one phantom all -1 node."""
    n, r = neighbors.shape
    if (2 * r_pad) % 128 or r_pad < r:
        raise ValueError(f"r_pad={r_pad} must cover R={r} and make 2*r_pad a multiple of 128")
    if n % 2:
        neighbors = np.concatenate([neighbors, np.full((1, r), -1, np.int32)], axis=0)
        n += 1
    if r < r_pad:
        out = np.full((n, r_pad), -1, np.int32)
        out[:, :r] = neighbors
        neighbors = out
    return np.ascontiguousarray(neighbors, np.int32).reshape(n // 2, 2 * r_pad)


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(arr), device=device)


@dataclasses.dataclass
class OnDiskIndex:
    """A loaded index: graph arrays + feature arrays + metadata."""

    reader: IndexFileReader

    @property
    def meta(self) -> dict:
        return self.reader.meta

    @property
    def features(self) -> list[str]:
        return self.meta.get("features", [])

    def graph_to_device(self, device: torch.device | str | None = None) -> GraphIndex:
        """Upload only the graph arrays (no features) to ``device`` (default:
        the card)."""
        device = resolve_device(device)
        r = self.reader
        layers, level_ids = [], []
        for lv in range(self.meta["num_levels"]):
            nbrs = _tensor(_read_l0_neighbors(r) if lv == 0 else r.read(f"graph/L{lv}/neighbors"), device)
            counts = _tensor(r.read(f"graph/L{lv}/counts"), device)
            name = f"graph/L{lv}/scores"
            if r.has_array(name):
                scores = _tensor(r.read(name), device)
            else:
                scores = torch.where(nbrs >= 0, 0.0, NEG_INF).to(torch.float32)
            layers.append(GraphLayer(neighbors=nbrs, scores=scores, counts=counts))
            if lv >= 1:
                level_ids.append(_tensor(r.read(f"graph/L{lv}/node_ids"), device))
        n_cap = layers[0].neighbors.shape[0]
        if r.has_array("graph/deleted"):
            deleted = _tensor(r.read("graph/deleted"), device)
        else:
            deleted = torch.zeros((n_cap,), dtype=torch.bool, device=device)
        return GraphIndex(
            layers=tuple(layers),
            level_node_ids=tuple(level_ids),
            entry_node=torch.tensor(int(self.meta["entry_node"]), dtype=torch.int32, device=device),
            num_nodes=torch.tensor(int(self.meta["num_nodes"]), dtype=torch.int32, device=device),
            deleted=deleted,
        )

    def to_device(self, device: torch.device | str | None = None):
        """``(graph, {feature: {array: tensor}})`` on ``device``."""
        device = resolve_device(device)
        graph = self.graph_to_device(device)
        r = self.reader
        feats = {
            name: {key.split("/", 2)[2]: _tensor(r.read(key), device)
                   for key in r.array_names() if key.startswith(f"feature/{name}/")}
            for name in self.features
        }
        return graph, feats


def sequential_renumbering(graph: GraphIndex) -> np.ndarray | None:
    """Old -> new ordinal map that compacts deleted holes (reference
    ``sequentialRenumbering``); None when there are no holes."""
    deleted = _np(graph.deleted)
    n = int(graph.num_nodes)
    live = ~deleted[:n]
    if live.all():
        return None
    mapper = np.full(deleted.shape[0], -1, np.int32)
    mapper[:n][live] = np.arange(int(live.sum()), dtype=np.int32)
    return mapper


def _remap_layer(neighbors, scores, counts, mapper, row_select):
    """Gather live rows and remap their edge ids through ``mapper``."""
    nbrs = neighbors[row_select]
    sc = scores[row_select]
    cnt = counts[row_select]
    remapped = np.where(nbrs >= 0, mapper[np.maximum(nbrs, 0)], -1)
    # dropped (deleted) neighbors lose their slot; compact each row
    out_n = np.full_like(remapped, -1)
    out_s = np.full_like(sc, -np.inf)
    out_c = np.zeros_like(cnt)
    for i in range(remapped.shape[0]):
        keep = remapped[i] >= 0
        k = int(keep.sum())
        out_n[i, :k] = remapped[i][keep]
        out_s[i, :k] = sc[i][keep]
        out_c[i] = k
    return out_n, out_s, out_c


def write_index(
    path: str | os.PathLike,
    graph: GraphIndex,
    features: dict[str, dict[str, np.ndarray | torch.Tensor]] | None = None,
    save_scores: bool = False,
    renumber: bool = True,
    paired_adjacency: bool = False,
    **meta,
) -> None:
    """Persist a :class:`GraphIndex` (+ feature arrays) to ``path``.

    ``features`` maps FeatureId -> {array name -> array}.  Edge scores are
    dropped unless ``save_scores``.  With deleted holes and ``renumber``,
    ordinals are compacted on save: per-node feature arrays are re-gathered
    and the old -> new map is stored as ``ordinal_mapper``.
    ``paired_adjacency=True`` writes the v3 paired L0 layout; it refuses
    graphs with holes (under ``renumber``) and ``save_scores=True``, since
    the paired layout carries neither.
    """
    features = features or {}
    mapper = sequential_renumbering(graph) if renumber else None
    if paired_adjacency and save_scores:
        raise ValueError("paired_adjacency=True stores no edge scores: pass save_scores=False")
    if mapper is not None:
        if paired_adjacency:
            raise ValueError(
                "paired_adjacency=True is not supported for graphs with deleted holes (save-time "
                "renumbering): compact the holes first, or pass renumber=False"
            )
        _write_index_renumbered(path, graph, features, save_scores, mapper, meta)
        return
    with IndexFileWriter(path, version=3 if paired_adjacency else None) as w:
        for lv, layer in enumerate(graph.layers):
            if lv == 0 and paired_adjacency:
                nbrs = _np(layer.neighbors)
                r = nbrs.shape[1]
                w.add_array("graph/L0/neighbors_paired", pack_adjacency_pairs_host(nbrs, ((max(r, 1) + 63) // 64) * 64))
                w.add_array("graph/L0/counts", layer.counts)
                w.set_meta(l0_layout="paired", l0_row_cap=r)
                continue
            w.add_array(f"graph/L{lv}/neighbors", layer.neighbors)
            w.add_array(f"graph/L{lv}/counts", layer.counts)
            if save_scores:
                w.add_array(f"graph/L{lv}/scores", layer.scores)
            if lv >= 1:
                w.add_array(f"graph/L{lv}/node_ids", graph.level_node_ids[lv - 1])
        for fname, arrays in features.items():
            for aname, arr in arrays.items():
                w.add_array(f"feature/{fname}/{aname}", arr)
        # with renumber=False, tombstones must survive the round trip
        deleted = _np(graph.deleted)
        if deleted.any():
            w.add_array("graph/deleted", deleted)
        w.set_meta(
            num_levels=graph.num_levels,
            entry_node=int(graph.entry_node),
            num_nodes=int(graph.num_nodes),
            features=list(features),
            **meta,
        )


def _write_index_renumbered(path, graph, features, save_scores, mapper, meta):
    """Save with the hole-compacting ordinal remap."""
    n = int(graph.num_nodes)
    deleted = _np(graph.deleted)
    live_rows = np.where(~deleted[:n])[0]
    with IndexFileWriter(path) as w:
        base = graph.base
        out_n, out_s, out_c = _remap_layer(_np(base.neighbors), _np(base.scores), _np(base.counts), mapper, live_rows)
        w.add_array("graph/L0/neighbors", out_n)
        w.add_array("graph/L0/counts", out_c)
        if save_scores:
            w.add_array("graph/L0/scores", out_s.astype(np.float32))
        num_levels = 1
        for lv in range(1, graph.num_levels):
            ids_l = _np(graph.level_node_ids[lv - 1])
            live_slots = np.where(mapper[ids_l] >= 0)[0]
            if len(live_slots) == 0:
                break
            # remap slot-space adjacency to the compacted slot space
            slot_map = np.full(len(ids_l), -1, np.int32)
            slot_map[live_slots] = np.arange(len(live_slots), dtype=np.int32)
            layer = graph.layers[lv]
            ln, ls, lc = _remap_layer(_np(layer.neighbors), _np(layer.scores), _np(layer.counts), slot_map, live_slots)
            w.add_array(f"graph/L{num_levels}/neighbors", ln)
            w.add_array(f"graph/L{num_levels}/counts", lc)
            if save_scores:
                w.add_array(f"graph/L{num_levels}/scores", ls.astype(np.float32))
            w.add_array(f"graph/L{num_levels}/node_ids", mapper[ids_l[live_slots]])
            num_levels += 1
        for fname, arrays in features.items():
            for aname, arr in arrays.items():
                arr = _np(arr)
                if arr.ndim >= 1 and arr.shape[0] in (n, deleted.shape[0]):
                    arr = arr[live_rows]  # per-node payload follows the remap
                w.add_array(f"feature/{fname}/{aname}", arr)
        w.add_array("ordinal_mapper", mapper)
        entry = int(graph.entry_node)
        new_entry = int(mapper[entry]) if entry >= 0 and mapper[entry] >= 0 else 0
        w.set_meta(
            num_levels=num_levels, entry_node=new_entry, num_nodes=len(live_rows), features=list(features),
            renumbered=True, **meta,
        )


def load_index(path: str | os.PathLike) -> OnDiskIndex:
    return OnDiskIndex(reader=IndexFileReader(path))
