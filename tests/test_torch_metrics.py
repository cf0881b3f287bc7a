"""ladine_tpu_torch's metrics against ladine_tpu's on the CPU: every
function of ``metrics/classification.py`` and ``metrics/uncertainty.py`` on
the same seeded numpy inputs, float32 on both sides, exact or within 1e-6.

The cases include empty ECE bins (0.0 in the ECE, 0.0 in the reliability
bins), a confidence exactly on a bin edge (it falls in the lower bin, as
torchmetrics bins it), empty (class, correctness) groups (NaN for the PIW,
0.0 for the MC variance) and tied votes (the smaller class).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladine_tpu.metrics import classification as jc
from ladine_tpu.metrics import uncertainty as ju
from ladine_tpu_torch.metrics import classification as tc
from ladine_tpu_torch.metrics import uncertainty as tu
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


def _samples(seed, s=12, b=9, c=3):
    rng = np.random.default_rng(seed)
    return rng.normal(0.5, 0.6, (s, b, c)).astype(np.float32), rng.integers(0, c, b)


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol, equal_nan=True)


@pytest.mark.parametrize("temperature", [0.05, 0.1737, 1.0])
def test_convert_to_prob_and_ensemble_confidence(temperature):
    s, _ = _samples(0)
    _close(tc.convert_to_prob(torch.from_numpy(s), temperature), jc.convert_to_prob(jnp.asarray(s), temperature))
    _close(tc.ensemble_confidence(torch.from_numpy(s), temperature),
           jc.ensemble_confidence(jnp.asarray(s), temperature))


def test_majority_vote_ties_go_to_the_smaller_class():
    s, _ = _samples(1)
    np.testing.assert_array_equal(tc.majority_vote(torch.from_numpy(s)).numpy(),
                                  np.asarray(jc.majority_vote(jnp.asarray(s))))
    tie = np.zeros((4, 1, 3), np.float32)
    tie[0, 0, 2] = tie[1, 0, 2] = tie[2, 0, 1] = tie[3, 0, 1] = 1.0
    assert int(tc.majority_vote(torch.from_numpy(tie))[0]) == 1 == int(jc.majority_vote(jnp.asarray(tie))[0])


@pytest.mark.parametrize("topk", [(1,), (1, 2), (1, 5)])
def test_accuracy_topk(topk):
    rng = np.random.default_rng(2)
    out = rng.random((11, 4)).astype(np.float32)
    out[3] = out[3, 0]  # a row of ties
    labels = rng.integers(0, 4, 11)
    got = tc.accuracy_topk(torch.from_numpy(out), torch.from_numpy(labels), topk)
    want = jc.accuracy_topk(jnp.asarray(out), jnp.asarray(labels), topk)
    for g, w in zip(got, want):
        _close(g, w)


def _probs_cases():
    rng = np.random.default_rng(3)
    p = rng.dirichlet(np.ones(3), 40).astype(np.float32)
    labels = rng.integers(0, 3, 40)
    # confident rows only: the low bins are empty
    sharp = np.full((6, 2), 0.05, np.float32)
    sharp[:, 0] = 0.95
    # confidences exactly on bin edges (0.5, 0.7, 0.8): the lower bin
    edges = np.array([[0.5, 0.5], [0.7, 0.3], [0.8, 0.2], [0.25, 0.75]], np.float32)
    return {"dirichlet": (p, labels), "empty-bins": (sharp, np.array([0, 0, 1, 0, 1, 0])),
            "bin-edges": (edges, np.array([0, 1, 0, 1]))}


@pytest.mark.parametrize("case", sorted(_probs_cases()))
def test_ece_and_reliability_bins(case):
    p, labels = _probs_cases()[case]
    tp, tl, jp, jl = torch.from_numpy(p), torch.from_numpy(labels), jnp.asarray(p), jnp.asarray(labels)
    _close(tc.ece(tp, tl), jc.ece(jp, jl))
    _close(tc.ece(tp, tl, n_bins=15), jc.ece(jp, jl, n_bins=15))
    for g, w in zip(tc.reliability_bins(tp, tl), jc.reliability_bins(jp, jl)):
        _close(g, w)
    if case == "bin-edges":
        count = tc.reliability_bins(tp, tl)[0]
        assert count[4] == 1 and count[6] == 1 and count[7] == 2  # 0.5 -> 4, 0.7 -> 6, 0.75/0.8 -> 7
    if case == "empty-bins":
        count, conf, acc = tc.reliability_bins(tp, tl)
        assert (count[:9] == 0).all() and (conf[:9] == 0).all() and (acc[:9] == 0).all()


@pytest.mark.parametrize("case", sorted(_probs_cases()))
def test_nll_and_brier(case):
    p, labels = _probs_cases()[case]
    tp, tl, jp, jl = torch.from_numpy(p), torch.from_numpy(labels), jnp.asarray(p), jnp.asarray(labels)
    for eps in (0.0, 1e-12):
        _close(tc.nll(tp, tl, eps=eps), jc.nll(jp, jl, eps=eps))
    _close(tc.brier(tp, tl), jc.brier(jp, jl))


def _groups_cases():
    s, labels = _samples(4)
    pred = np.array(jc.majority_vote(jnp.asarray(s)))
    # every prediction right: the incorrect groups are all empty; class 2
    # never predicted: its correct group is empty too
    s2, _ = _samples(5, c=3)
    s2[..., 2] = -5.0
    pred2 = np.array(jc.majority_vote(jnp.asarray(s2)))
    return {"random": (s, pred, labels), "empty-groups": (s2, pred2, pred2.copy())}


@pytest.mark.parametrize("case", sorted(_groups_cases()))
def test_piw_and_mc_variance_per_class(case):
    s, pred, labels = _groups_cases()[case]
    ts, tp, tl = torch.from_numpy(s), torch.from_numpy(pred), torch.from_numpy(labels)
    js, jp, jl = jnp.asarray(s), jnp.asarray(pred), jnp.asarray(labels)
    for g, w in zip(tu.piw_per_class(ts, tp, tl), ju.piw_per_class(js, jp, jl)):
        _close(g, w)
    for g, w in zip(tu.piw_per_class(ts, tp, tl, 10.0, 90.0), ju.piw_per_class(js, jp, jl, 10.0, 90.0)):
        _close(g, w)
    for g, w in zip(tu.mc_variance_per_class(ts, tp, tl), ju.mc_variance_per_class(js, jp, jl)):
        _close(g, w)
    if case == "empty-groups":
        piw_c, piw_i = tu.piw_per_class(ts, tp, tl)
        var_c, var_i = tu.mc_variance_per_class(ts, tp, tl)
        assert torch.isnan(piw_i).all() and torch.isnan(piw_c[2])
        assert (var_i == 0).all() and var_c[2] == 0


def test_ttest_certainty_and_pavpu():
    s, labels = _samples(6, s=30)
    s[:, :3, 1] += 2.0  # clearly separated instances
    got_c, got_p = tu.ttest_certainty(s)
    want_c, want_p = ju.ttest_certainty(s)
    np.testing.assert_array_equal(got_c, want_c)
    _close(got_p, want_p)
    probs = np.asarray(jc.ensemble_confidence(jnp.asarray(s), 0.2))
    assert tu.pavpu(probs, labels, ~got_c) == ju.pavpu(probs, labels, ~want_c)
