"""The port's larger-than-memory build on real-valued data: its recall,
served off its own file, within 0.01 of the JAX package's.

Off the integer grid the two frameworks round scores differently, so the
graphs differ edge by edge; what must agree is what the user measures.  Both
packages stream-build the same clustered corpus in the packed regime (the K3
path: ``_FUSED_BUILD_BUDGET`` set to 0 in both) with the hierarchy, and each
serves its own file through ``HostGraphIndex`` with the default exact rerank.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.disk import host_graph as jhg
from jvector_tpu.disk import ltm as jltm
from jvector_tpu.graph import GraphConfig as JConfig
from jvector_tpu.util.datasets import recall_at_k, synthetic_dataset
from jvector_tpu_torch.disk import host_graph as thg
from jvector_tpu_torch.disk import ltm as tltm
from jvector_tpu_torch.graph import GraphConfig

N, D, Q = 2500, 32, 200
CFG = dict(max_degree=16, ef_construction=40, wave_size=256, add_hierarchy=True)
SLACK = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one torch thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_ltm_packed_recall_matches_jax(tmp_path, monkeypatch):
    ds = synthetic_dataset(n=N, dim=D, n_queries=Q, k=10, n_clusters=16, seed=11)
    monkeypatch.setattr(jltm, "_FUSED_BUILD_BUDGET", 0)
    monkeypatch.setattr(tltm, "_FUSED_BUILD_BUDGET", 0)
    jp, tp = tmp_path / "jax.jvtpu", tmp_path / "torch.jvtpu"
    jltm.build_on_disk_ltm(str(jp), ds.base, N, D, config=JConfig(**CFG), compression="sq4")
    phases = []
    tltm.build_on_disk_ltm(str(tp), ds.base, N, D, config=GraphConfig(**CFG), compression="sq4", device="cpu",
                           on_phase=lambda name, s: phases.append(name))
    assert "waves/packed" in phases
    kw = dict(top_k=10, beam_width=24, expand=4)
    ja = jhg.HostGraphIndex.load(str(jp)).search(jnp.asarray(ds.queries), **kw)
    tb = thg.HostGraphIndex.load(str(tp), device="cpu").search(ds.queries, **kw)
    r_jax = recall_at_k(np.asarray(ja.ids), ds.ground_truth, 10)
    r_port = recall_at_k(tb.ids.numpy(), ds.ground_truth, 10)
    assert r_jax > 0.8, r_jax  # the reference itself works on this corpus
    assert abs(r_port - r_jax) <= SLACK, (r_port, r_jax)
