"""ladine_tpu_torch's robust evaluation against ladine_tpu's on the CPU.

* ``make_eval_pipeline``: the port's samples (M, K, B, C) against the JAX
  pipeline's, on the same weights (``utils/convert.py``) with every
  corruption on and FGSM, the JAX pipeline's own draws injected
  (``torch_parity.jax_eval_draws``), at the ancestral chain and DDIM-5, with
  ``selected_members``, ``head_indices`` and the int8 flags. float32 within
  1e-5 (the int8 paths 1e-3: a float32 sum in another order can flip one
  int8 code, ``tests/test_torch_serve.py``). One bf16 case, with the flax
  trees rounded to bf16 values, holds to ``tests/test_torch_bf16.py``'s
  parity tolerance (5e-3); it runs the corruptions without an attack, since
  a bf16 gradient's sign is no stable thing to compare.
* ``evaluate_ensemble`` over a ragged pair of batches: the samples of the
  pipeline batch by batch, the JAX report's keys, a log line per batch.
* ``compute_report`` key by key against the JAX report (1e-6), and the
  calibration: ``temperature_search`` within its ``xatol`` (with scipy and
  with its geomspace scan) and ``tune_temperature_nll`` within 1e-4.
"""

import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladine_tpu.infer import EvalConfig as JaxEvalConfig
from ladine_tpu.infer import calibrate as jcal
from ladine_tpu.infer import evaluator as jev
from ladine_tpu.models import ConditionalModel as JaxConditionalModel
from ladine_tpu.models import SEViTGuidance as JaxGuidance
from ladine_tpu.ops import DiffusionSchedule as JaxSchedule
from ladine_tpu_torch.infer import calibrate as tcal
from ladine_tpu_torch.infer import evaluator as tev
from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance
from ladine_tpu_torch.ops import DiffusionSchedule, ddim_timesteps
from ladine_tpu_torch.utils import guidance_from_flax, members_from_flax
from torch_parity import jax_eval_draws, jax_members, one_torch_thread  # noqa: F401 (autouse)

G = dict(num_classes=2, num_members=3, vit_depth=3, img_size=16, patch_size=8, embed_dim=16,
         num_heads=2, mlp_hidden_dims=(16, 8, 8))
T, D, FEAT = 20, 768, 8
CORRUPT = dict(noise_std=0.05, low_resolution=2, brightness=0.1, contrast=0.8, cover=(0.05, 2), crop=0.1)


def _bf16_values(tree):
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)), tree)


def _parts(dtype=None):
    gvars = jax.tree.map(np.asarray, jax.jit(JaxGuidance(**G).init)(jax.random.PRNGKey(0),
                                                                    jnp.zeros((1, 16, 16, 3))))
    stacked = jax_members(JaxConditionalModel(data_dim=D, feature_dim=FEAT, hidden_dim=FEAT, y_dim=2,
                                              n_steps=T + 1), 3, D)
    jdtype = None
    if dtype == torch.bfloat16:
        gvars, stacked, jdtype = _bf16_values(gvars), _bf16_values(stacked), jnp.bfloat16
    g = SEViTGuidance(**G, device="cpu", dtype=dtype)
    g.load_state_dict(guidance_from_flax(gvars))
    m = ConditionalModel(3, D, FEAT, FEAT, 2, T + 1, device="cpu", dtype=dtype)
    m.load_state_dict(members_from_flax(stacked))
    return dict(jg=JaxGuidance(**G, dtype=jdtype), gvars=gvars, stacked=stacked, g=g, m=m,
                jm=JaxConditionalModel(data_dim=D, feature_dim=FEAT, hidden_dim=FEAT, y_dim=2,
                                       n_steps=T + 1, dtype=jdtype))


@pytest.fixture(scope="module")
def parts():
    return _parts()


def _schedules():
    return JaxSchedule.create("linear", T, 1e-4, 0.02), DiffusionSchedule.create("linear", T, 1e-4, 0.02,
                                                                                device="cpu")


def _batch(seed, b=4):
    rng = np.random.default_rng(seed)
    return rng.random((b, 16, 16, 3), dtype=np.float32), rng.integers(0, 2, b)


def _run_pair(parts, kw, seed=0, b=4):
    """The JAX pipeline's samples and the port's on one batch, the JAX
    draws injected."""
    jsched, tsched = _schedules()
    jcfg = JaxEvalConfig(mc_trials=2, temperature=0.2, **kw)
    tcfg = tev.EvalConfig(mc_trials=2, temperature=0.2, **kw)
    images, labels = _batch(seed, b)
    key = jax.random.PRNGKey(17 + seed)
    want = jev.make_eval_pipeline(parts["jg"], parts["gvars"], parts["jm"], jsched, jcfg)(
        parts["stacked"], jnp.asarray(images), jnp.asarray(labels), key)
    pipe = tev.make_eval_pipeline(parts["g"], parts["m"], tsched, tcfg, device="cpu")
    members = len(kw.get("selected_members") or ()) or 3
    n_draws = len(ddim_timesteps(T, tcfg.ddim_steps, tcfg.skip_type)) if tcfg.ddim_steps else T
    draws, _ = jax_eval_draws(key, tcfg, images.shape, members, n_draws)
    got = pipe(images, labels, draws=draws)
    return np.asarray(want), got.numpy()


FGSM = dict(CORRUPT, attack_name="FGSM", attack_eps=0.03)
CASES = {
    "ancestral-corrupt-fgsm": (FGSM, 1e-5),
    "ddim5-corrupt-fgsm": (dict(FGSM, ddim_steps=5), 1e-5),
    "ddim5-eta0-noise-prior": (dict(CORRUPT, ddim_steps=5, ddim_eta=0.0, noise_prior=True), 1e-5),
    "selected-members": (dict(FGSM, ddim_steps=5, selected_members=(0, 2)), 1e-5),
    "head-indices-with-vit": (dict(CORRUPT, ddim_steps=5, head_indices=(2, 0, 3)), 1e-5),
    "int8-fast": (dict(FGSM, ddim_steps=3, use_int8=True, use_int8_encode=True), 1e-3),
    "int8-pallas": (dict(FGSM, ddim_steps=3, use_int8_pallas=True), 1e-3),
    "int8-pallas-fuse-ends": (dict(FGSM, ddim_steps=3, use_int8_pallas=True, pallas_fuse_ends=True), 1e-3),
}


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_matches_jax(parts, name):
    kw, tol = CASES[name]
    want, got = _run_pair(parts, kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_bf16_pipeline_matches_jax():
    want, got = _run_pair(_parts(torch.bfloat16), dict(CORRUPT), seed=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)


class _Mesh2x1:
    """A (member 2, data 1) mesh as ``parallel/mesh.py`` reads one, rank 0."""

    mesh_dim_names = ("member", "data")

    def get_local_rank(self, axis):
        return 0

    def size(self, dim):
        return (2, 1)[dim]


def test_pipeline_refuses_a_mesh_and_needs_cuda_unless_asked_for_cpu(parts, monkeypatch):
    """A mesh whose member axis does not tile the members is refused (the
    sharded pipeline itself: ``tests/test_torch_parallel_infer.py``)."""
    _, tsched = _schedules()
    with pytest.raises(ValueError, match="do not tile the member axis of size 2"):
        tev.make_eval_pipeline(parts["g"], parts["m"], tsched, tev.EvalConfig(), mesh=_Mesh2x1(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tev.make_eval_pipeline(parts["g"], parts["m"], tsched, tev.EvalConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tev.evaluate_ensemble(parts["g"], parts["m"], tsched, [_batch(0)], tev.EvalConfig())


def test_eval_config_has_the_jax_fields_and_defaults():
    import dataclasses

    assert ({f.name: f.default for f in dataclasses.fields(tev.EvalConfig)}
            == {f.name: f.default for f in dataclasses.fields(JaxEvalConfig)})


def test_evaluate_ensemble_over_ragged_batches(parts, caplog):
    _, tsched = _schedules()
    cfg = tev.EvalConfig(mc_trials=2, temperature=0.2, ddim_steps=5, attack_name="PGD", **CORRUPT)
    batches = [_batch(2, 4), _batch(3, 3)]
    seconds = {}
    with caplog.at_level(logging.INFO, logger="ladine_tpu_torch"):
        report = tev.evaluate_ensemble(parts["g"], parts["m"], tsched, batches, cfg,
                                       generator=torch.Generator().manual_seed(5), device="cpu",
                                       seconds=seconds)
    assert [r.getMessage() for r in caplog.records] == ["eval batch 0 done (4 instances)",
                                                       "eval batch 1 done (7 instances)"]
    assert report["samples"].shape == (6, 7, 2) and np.isfinite(report["samples"]).all()
    assert report["num_instances"] == 7 and report["num_samples"] == 6
    assert len(report["per_member_mv_accuracy"]) == 3
    assert [sorted(s) for s in seconds["batches"]] == [["attack", "corrupt", "sample"]] * 2
    # the same samples, batch by batch through the pipeline on the same generator
    pipe = tev.make_eval_pipeline(parts["g"], parts["m"], tsched, cfg, device="cpu")
    gen = torch.Generator().manual_seed(5)
    again = [pipe(x, y, gen).reshape(6, len(y), 2).numpy() for x, y in batches]
    np.testing.assert_array_equal(report["samples"], np.concatenate(again, axis=1))
    # the JAX evaluate_ensemble's keys: its compute_report with num_members
    assert sorted(report) == sorted(jev.compute_report(report["samples"], report["labels"], 0.2, 3))


def _synthetic_samples(n=200, s=40, seed=0):
    """MC outputs near the one-hot vertices with class-dependent noise, so
    that the temperature matters (the JAX package's calibration tests)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    correct = rng.random(n) < 0.85
    target = np.where(correct[:, None], np.eye(2)[labels], 1 - np.eye(2)[labels])
    return (target[None] + rng.normal(scale=0.25, size=(s, n, 2))).astype(np.float32), labels


@pytest.mark.parametrize("num_members", [None, 4, 3], ids=["no-members", "4-members", "3-not-dividing"])
def test_compute_report_matches_jax(num_members):
    samples, labels = _synthetic_samples(n=60, s=20, seed=1)
    samples[:, :5] = np.array([1.0, 0.0], np.float32)  # certain rows: a full top bin, zero PIW
    got = tev.compute_report(samples, labels, 0.2, num_members=num_members)
    want = jev.compute_report(samples, labels, 0.2, num_members=num_members)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k == "reliability":
            for part in ("count", "confidence", "accuracy"):
                np.testing.assert_allclose(got[k][part], w[part], rtol=1e-6, atol=1e-6, err_msg=part)
        elif k in ("samples", "labels"):
            np.testing.assert_array_equal(got[k], w)
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-6, equal_nan=True, err_msg=k)


def test_calibration_objective_matches_jax():
    samples, labels = _synthetic_samples()
    for t in (0.05, 0.2555, 1.0):
        assert abs(tcal.calibration_objective(samples, labels, t)
                   - jcal.calibration_objective(samples, labels, t)) <= 1e-6


@pytest.mark.parametrize("scipy", [True, False], ids=["nelder-mead", "geomspace-scan"])
def test_temperature_search_matches_jax(scipy, monkeypatch):
    if not scipy:
        monkeypatch.setitem(sys.modules, "scipy.optimize", None)  # the import raises ImportError
    samples, labels = _synthetic_samples()
    t, e = tcal.temperature_search(samples, labels)
    jt, je = jcal.temperature_search(samples, labels)
    assert abs(t - jt) <= 1e-4 and abs(e - je) <= 1e-5
    assert e <= tcal.calibration_objective(samples, labels, 0.2555) + 1e-9


def test_tune_temperature_nll_matches_jax():
    samples, labels = _synthetic_samples()
    t = tcal.tune_temperature_nll(samples, labels, steps=100)
    jt = jcal.tune_temperature_nll(samples, labels, steps=100)
    assert abs(t - jt) <= 1e-4 and t != 0.2555
