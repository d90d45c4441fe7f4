"""IPC text-protocol service (counterpart of ``jvector_tpu/bench/ipc.py``).

Reference: ``jvector-examples/.../IPCService.java:80-308``, a text protocol
over a Unix domain socket:

    CREATE <dim> <similarity> <M> <ef>
    WRITE [v1,v2,...] [v1,v2,...] ...
    OPTIMIZE
    SEARCH <ef> <topK> [q...] [q...] ...
    MEMORY
    SAVE <path>                (persist the optimized index)
    LOAD <path>                (serve a previously saved index)

Responses: ``OK``, ``OK <value>``, ``RESULT <ids...>;<ids...>``,
``ERROR <msg>``.  SEARCH batches every query of the command into one wave.
The service runs every session on its ``device`` (the card unless the
caller asks for the CPU): the first OPTIMIZE is ``build_graph``'s default
SQ4 build, a later one ``mutation.add_nodes``.
"""

from __future__ import annotations

import os
import socket
import socketserver
import threading
import time
import traceback

import numpy as np
import torch

from jvector_tpu_torch.util.device import resolve_device


class _State:
    def __init__(self):
        self.reset()

    def reset(self):
        self.dim = None
        self.sim = "euclidean"
        self.config = None
        self.pending: list[np.ndarray] = []
        self.graph = None
        self.provider = None


def _parse_vectors(text: str) -> np.ndarray:
    """Parse ``[1.0,2.0,...] [..] ...`` vector groups (each number read as a
    Python float, then stored as float32)."""
    vecs = []
    for part in text.split("]"):
        part = part.strip().lstrip("[").strip()
        if not part:
            continue
        vecs.append(np.array([float(x) for x in part.split(",") if x.strip()], np.float32))
    return np.stack(vecs) if vecs else np.zeros((0, 0), np.float32)


class IPCService:
    """One session per connection, each on ``device``, over a Unix socket."""

    def __init__(self, socket_path: str, device: torch.device | str | None = None):
        self.socket_path = socket_path
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._server = None
        self._thread = None

    # --- command handlers ---------------------------------------------------

    def _handle(self, state: _State, line: str) -> str:
        try:
            cmd, _, rest = line.strip().partition(" ")
            cmd = cmd.upper()
            if cmd == "CREATE":
                dim, sim, m, ef = rest.split()
                from jvector_tpu_torch.graph import GraphConfig

                state.reset()
                state.dim = int(dim)
                state.sim = sim.lower()
                state.config = GraphConfig(max_degree=int(m), ef_construction=int(ef), wave_size=256)
                return "OK"
            if cmd == "WRITE":
                v = _parse_vectors(rest)
                if state.dim is None:
                    return "ERROR no index (CREATE first)"
                if v.shape[1] != state.dim:
                    return f"ERROR expected dim {state.dim}, got {v.shape[1]}"
                state.pending.append(v)
                return "OK"
            if cmd == "OPTIMIZE":
                if state.dim is None:
                    return "ERROR no index (CREATE first)"
                from jvector_tpu_torch.graph import build_graph
                from jvector_tpu_torch.graph.mutation import add_nodes

                data = np.concatenate(state.pending) if state.pending else None
                if data is None or not len(data):
                    return "ERROR no vectors written"
                if state.graph is None:
                    state.graph, state.provider = build_graph(data, state.sim, state.config, device=self.device)
                else:
                    state.graph, state.provider = add_nodes(state.graph, state.provider, data, state.config)
                state.pending = []
                return f"OK {int(state.graph.num_nodes)}"
            if cmd == "SEARCH":
                if state.graph is None:
                    return "ERROR no optimized index (OPTIMIZE first)"
                parts = rest.split(None, 2)
                ef, top_k = int(parts[0]), int(parts[1])
                queries = _parse_vectors(parts[2] if len(parts) > 2 else "")
                if not len(queries):
                    return "ERROR no queries"
                from jvector_tpu_torch.graph import search

                res = search(state.graph, state.provider, torch.as_tensor(queries, device=self.device),
                             top_k=top_k, beam_width=max(ef, top_k))
                ids = res.ids.cpu().numpy()
                return "RESULT " + ";".join(" ".join(str(int(x)) for x in row if x >= 0) for row in ids)
            if cmd == "SAVE":
                if state.graph is None:
                    return "ERROR no optimized index (OPTIMIZE first)"
                from jvector_tpu_torch.disk.format import FeatureId, write_index

                n = int(state.graph.num_nodes)
                write_index(
                    rest.strip(),
                    state.graph,
                    features={FeatureId.INLINE_VECTORS: {"vectors": state.provider.vectors[:n].cpu().numpy()}},
                    renumber=False,
                    similarity=state.sim,
                    dimension=state.dim,
                )
                return "OK"
            if cmd == "LOAD":
                from jvector_tpu_torch.disk.format import load_index
                from jvector_tpu_torch.graph.score import ExactScoreProvider
                from jvector_tpu_torch.ops.similarity import SimilarityFunction

                idx = load_index(rest.strip())
                graph, feats = idx.to_device(self.device)
                vecs = feats["inline_vectors"]["vectors"]
                pad = graph.capacity - vecs.shape[0]
                if pad > 0:
                    vecs = torch.nn.functional.pad(vecs, (0, 0, 0, pad))
                state.reset()
                state.dim = int(vecs.shape[1])
                state.sim = idx.meta.get("similarity", "euclidean")
                state.graph = graph
                state.provider = ExactScoreProvider(vectors=vecs, sim=SimilarityFunction.parse(state.sim))
                return f"OK {int(graph.num_nodes)}"
            if cmd == "MEMORY":
                from jvector_tpu_torch.util.accounting import bytes_used

                used = 0
                if state.graph is not None:
                    used += bytes_used(state.graph) + bytes_used(state.provider)
                return f"OK {used}"
            return f"ERROR unknown command {cmd}"
        except Exception as e:  # the protocol answers every command; a failure is an ERROR reply
            traceback.print_exc()
            return f"ERROR {type(e).__name__}: {e}"

    # --- server lifecycle ------------------------------------------------------

    def serve_forever(self):
        handle, device = self._handle, self.device

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                if device.type == "cuda":
                    torch.cuda.set_device(device)
                state = _State()
                for raw in self.rfile:
                    line = raw.decode().strip()
                    if not line:
                        continue
                    if line.upper() == "QUIT":
                        break
                    self.wfile.write((handle(state, line) + "\n").encode())
                    self.wfile.flush()

        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)

        class Server(socketserver.ThreadingUnixStreamServer):
            daemon_threads = True

        self._server = Server(self.socket_path, Handler)
        self._server.serve_forever()

    def start(self):
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()
        for _ in range(200):  # wait for the socket to appear
            if os.path.exists(self.socket_path):
                return
            time.sleep(0.01)
        raise RuntimeError("IPC socket did not come up")

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


class IPCClient:
    """Minimal line-protocol client (for tests and tooling)."""

    def __init__(self, socket_path: str):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.connect(socket_path)
        self.f = self.sock.makefile("rwb")

    def call(self, line: str) -> str:
        self.f.write((line + "\n").encode())
        self.f.flush()
        return self.f.readline().decode().strip()

    def close(self):
        try:
            self.f.write(b"QUIT\n")
            self.f.flush()
        except OSError:
            pass
        self.f.close()
        self.sock.close()
