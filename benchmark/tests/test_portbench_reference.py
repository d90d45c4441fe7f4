"""The plain reference against a brute force checked by hand."""

import pytest
import torch

from benchmark.reference import exact


def test_topk_on_a_line_checked_by_hand():
    base = torch.tensor([[0.0], [1.0], [3.0], [6.0], [10.0]])
    queries = torch.tensor([[2.9], [0.4], [8.5]])
    assert exact.topk(base, queries, 2, "euclidean").tolist() == [[2, 1], [0, 1], [4, 3]]


def test_topk_dot_product_and_cosine_by_hand():
    base = torch.tensor([[1.0, 0.0], [0.0, 2.0], [3.0, 3.0]])
    q = torch.tensor([[1.0, 0.1]])
    assert exact.topk(base, q, 3, "dot_product").tolist() == [[2, 0, 1]]  # 3.3, 1.0, 0.2
    assert exact.topk(base, q, 3, "cosine").tolist() == [[0, 2, 1]]  # 0.995, 0.778, 0.0995


@pytest.mark.parametrize("sim,raw", [("euclidean", 25.0), ("dot_product", 0.0), ("cosine", 0.0)])
def test_pair_scores_are_jvectors_scores(sim, raw):
    base = torch.tensor([[3.0, 4.0], [0.0, 1.0]])
    queries = torch.tensor([[0.0, 0.0], [1.0, 0.0]])
    s = exact.pair_scores(base, queries, torch.tensor([0, 1]), torch.tensor([0, 1]), sim)
    assert s.dtype == torch.float64
    want = 1.0 / (1.0 + raw) if sim == "euclidean" else (1.0 + raw) / 2.0
    assert s[0 if sim == "euclidean" else 1].item() == pytest.approx(want, abs=1e-12)


def test_brute_force_agrees_with_float64_on_a_random_corpus():
    g = torch.Generator().manual_seed(3)
    base, q = torch.randn(500, 16, generator=g), torch.randn(40, 16, generator=g)
    d = ((q.double()[:, None, :] - base.double()[None]) ** 2).sum(-1)
    assert torch.equal(exact.topk(base, q, 10, "euclidean"), torch.topk(-d, 10, dim=1).indices)


def test_round_tf32_keeps_ten_mantissa_bits():
    one = 1.0
    ulp = 2.0**-10
    x = torch.tensor([one, one + ulp, one + ulp / 2, one + 3 * ulp / 2, one + ulp / 4, -(one + 3 * ulp / 2), 0.0])
    want = torch.tensor([one, one + ulp, one, one + 2 * ulp, one, -(one + 2 * ulp), 0.0])  # ties to even
    assert torch.equal(exact.round_tf32(x), want)


def test_tf32_control_differs_from_float32():
    g = torch.Generator().manual_seed(4)
    base, q = torch.randn(300, 64, generator=g), torch.randn(20, 64, generator=g)
    ids, scores = exact.topk_tf32(base, q, 5, "euclidean")
    ref = exact.pair_scores(base, q, torch.arange(20).repeat_interleave(5), ids.flatten(), "euclidean")
    gap = ((scores.flatten().double() - ref).abs() / ref).max().item()
    assert 1e-5 < gap < 1e-1
