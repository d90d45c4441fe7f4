"""The port's IPC service (``jvector_tpu_torch.bench.ipc``) against the JAX
package's.

``tests/test_ipc.py``'s four tests run against the port's service on the
CPU.  Then one session goes to both packages' services on an integer-grid
corpus (levels 0..15, where every score of the default SQ4 build is exact
in both frameworks and the builds are bit-equal, as
``tests/test_torch_build.py`` relies on): CREATE, WRITE, OPTIMIZE, WRITE,
the incremental OPTIMIZE (``add_nodes``) and SEARCH must give identical
replies, and MEMORY the same bytes (the graph's and the exact provider's
tensors are the JAX pytree's leaves, shape for shape).  A file SAVEd by
either service LOADs in the other and serves the same RESULT lines.
"""

import numpy as np
import pytest
import torch

from jvector_tpu.bench import ipc as jipc
from jvector_tpu_torch.bench.ipc import IPCClient, IPCService
from jvector_tpu_torch.util.datasets import synthetic_dataset


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def service(tmp_path):
    svc = IPCService(str(tmp_path / "jvtpu.sock"), device="cpu")
    svc.start()
    yield svc
    svc.stop()


def fmt(vs):
    return " ".join("[" + ",".join(f"{x:.5f}" for x in v) + "]" for v in vs)


def test_ipc_lifecycle(service):
    ds = synthetic_dataset(n=400, dim=8, n_queries=5, k=5, seed=3, device="cpu")
    c = IPCClient(service.socket_path)
    try:
        assert c.call("CREATE 8 euclidean 8 24") == "OK"
        for i in range(0, 400, 100):
            assert c.call("WRITE " + fmt(ds.base[i : i + 100])) == "OK"
        assert c.call("OPTIMIZE") == "OK 400"
        resp = c.call(f"SEARCH 24 5 {fmt(ds.queries[:3])}")
        assert resp.startswith("RESULT ")
        rows = resp[len("RESULT ") :].split(";")
        assert len(rows) == 3
        hits = sum(int(rows[q].split()[0]) in set(ds.ground_truth[q][:5].tolist()) for q in range(3))
        assert hits >= 2
        mem = c.call("MEMORY")
        assert mem.startswith("OK ") and int(mem.split()[1]) > 0
    finally:
        c.close()


def test_ipc_errors(service):
    c = IPCClient(service.socket_path)
    try:
        assert c.call("SEARCH 10 5 [1,2]").startswith("ERROR")
        assert c.call("WRITE [1,2,3]").startswith("ERROR")
        assert c.call("BOGUS").startswith("ERROR unknown")
        assert c.call("CREATE 4 euclidean 8 16") == "OK"
        assert c.call("WRITE [1,2,3]").startswith("ERROR expected dim 4")
        assert c.call("OPTIMIZE").startswith("ERROR no vectors")
        assert c.call("LOAD /nonexistent/index.jvtpu").startswith("ERROR FileNotFoundError")
        assert c.call("MEMORY") == "OK 0"
    finally:
        c.close()


def test_ipc_incremental_optimize(service):
    ds = synthetic_dataset(n=300, dim=8, n_queries=4, k=5, seed=9, device="cpu")
    c = IPCClient(service.socket_path)
    try:
        assert c.call("CREATE 8 euclidean 8 24") == "OK"
        assert c.call("WRITE " + fmt(ds.base[:200])) == "OK"
        assert c.call("OPTIMIZE") == "OK 200"
        assert c.call("WRITE " + fmt(ds.base[200:])) == "OK"
        assert c.call("OPTIMIZE") == "OK 300"  # incremental add_nodes path
        assert c.call(f"SEARCH 24 5 {fmt(ds.queries[:2])}").startswith("RESULT ")
    finally:
        c.close()


def test_ipc_save_load_roundtrip(service, tmp_path):
    data = np.random.default_rng(0).normal(size=(200, 8)).astype(np.float32)
    path = str(tmp_path / "ipc_index.jvtpu")
    c = IPCClient(service.socket_path)
    try:
        assert c.call("CREATE 8 euclidean 8 24") == "OK"
        assert c.call("WRITE " + fmt(data)).startswith("OK")
        assert c.call("OPTIMIZE").startswith("OK")
        assert c.call(f"SAVE {path}") == "OK"
    finally:
        c.close()
    c = IPCClient(service.socket_path)  # a fresh session serves from the file
    try:
        assert c.call(f"LOAD {path}") == "OK 200"
        resp = c.call("SEARCH 24 1 " + fmt(data[7:8]))
        assert resp.split()[1].split(";")[0] == "7"  # self-match
    finally:
        c.close()


# -- one session against both packages ---------------------------------------

N0, N1, D = 600, 800, 16


def _grid_corpus() -> np.ndarray:
    x = synthetic_dataset(n=N1, dim=D, n_queries=1, k=1, n_clusters=12, seed=21, device="cpu").base
    lo, hi = x.min(axis=0), x.max(axis=0)
    return np.clip(np.round((x - lo) / (hi - lo) * 15), 0, 15).astype(np.float32)


def _session(client, data: np.ndarray, queries: np.ndarray, save_to: str) -> list[str]:
    replies = [client.call("CREATE 16 euclidean 8 24")]
    replies += [client.call("WRITE " + fmt(data[i : i + 200])) for i in range(0, N0, 200)]
    replies.append(client.call("OPTIMIZE"))
    replies.append(client.call("SEARCH 24 5 " + fmt(queries)))
    replies.append(client.call("WRITE " + fmt(data[N0:])))
    replies.append(client.call("OPTIMIZE"))
    replies.append(client.call("SEARCH 24 5 " + fmt(queries)))
    replies.append(client.call("SEARCH 8 10 " + fmt(queries)))
    replies.append(client.call("MEMORY"))
    replies.append(client.call(f"SAVE {save_to}"))
    return replies


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ipc")
    data = _grid_corpus()
    queries = data[::53] + 0.25
    services = {"jax": jipc.IPCService(str(tmp / "jax.sock")), "torch": IPCService(str(tmp / "torch.sock"),
                                                                                   device="cpu")}
    clients = {"jax": jipc.IPCClient, "torch": IPCClient}
    out = {"tmp": tmp, "queries": queries, "services": services, "clients": clients, "replies": {}}
    for name, svc in services.items():
        svc.start()
        c = clients[name](svc.socket_path)
        try:
            out["replies"][name] = _session(c, data, queries, str(tmp / f"{name}.jvtpu"))
        finally:
            c.close()
    yield out
    for svc in services.values():
        svc.stop()


def test_one_session_gives_identical_replies(both):
    j, t = both["replies"]["jax"], both["replies"]["torch"]
    assert not any(r.startswith("ERROR") for r in j + t), (j, t)
    assert t[4] == "OK 600" and t[7] == "OK 800"
    assert t[5].startswith("RESULT ") and len(t[5].split(";")) == len(both["queries"])
    assert t == j


def test_memory_equals_the_jax_service(both):
    """The same tensors as the JAX pytree's leaves: a capacity-1024 graph
    (neighbors and scores [1024, 32], counts and deleted [1024], two
    scalars) and the exact provider's [1024, 16] float32 vectors."""
    mem_t, mem_j = both["replies"]["torch"][-2], both["replies"]["jax"][-2]
    assert mem_t == mem_j == f"OK {1024 * 32 * 4 * 2 + 1024 * 4 + 1024 + 2 * 4 + 1024 * 16 * 4}"


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_saved_index_loads_in_the_other_service(both, writer, reader):
    path = str(both["tmp"] / f"{writer}.jvtpu")
    results = {}
    for name in (writer, reader):
        c = both["clients"][name](both["services"][name].socket_path)
        try:
            assert c.call(f"LOAD {path}") == "OK 800"
            results[name] = [c.call(f"SEARCH {ef} {k} " + fmt(both["queries"])) for ef, k in ((24, 5), (8, 10))]
        finally:
            c.close()
    assert results[reader] == results[writer] == both["replies"][writer][8:10]
