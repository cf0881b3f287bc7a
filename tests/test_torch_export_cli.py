"""The export CLI and the kernels' custom ops, on the CPU.

``python -m ladine_tpu_torch.cli.export_bundle`` (counterpart of
``ladine_tpu/cli/export_bundle.py``) turns a ``Predictor.save`` artifact
into a bundle at a preset; the ``fast`` bundle must carry the resident int8
forms in place of the float weights they replace, and serve exactly as the
live ``fast`` predictor does. Each kernel's ``torch.library`` op passes
``torch.library.opcheck`` (schema, fake implementation against the real
one, dynamic shapes), and its CPU implementation is the plain version.
"""

import numpy as np
import pytest
import torch

from ladine_tpu_torch import kernels as K
from ladine_tpu_torch.infer import ExportedPredictor, Predictor
from ladine_tpu_torch.kernels.int8 import quantize_weight
from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance, init_random_
from ladine_tpu_torch.ops import DiffusionSchedule

G = dict(num_classes=2, num_members=3, vit_depth=3, img_size=16, patch_size=8, embed_dim=16,
         num_heads=2, mlp_hidden_dims=(16, 8, 8))
T = 20


def _images(seed, b):
    return np.random.default_rng(seed).random((b, 16, 16, 3)).astype(np.float32)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def fast_bundle(tmp_path_factory):
    """A fast-preset bundle from the export CLI at --max_batch 2: the exit
    code, the artifact and the loaded bundle."""
    from ladine_tpu_torch.cli.export_bundle import main as export_main

    root = tmp_path_factory.mktemp("cli")
    gen = torch.Generator().manual_seed(3)
    g = init_random_(SEViTGuidance(**G, device="cpu"), gen)
    m = init_random_(ConditionalModel(3, 768, 8, 8, 2, T + 1, device="cpu"), gen)
    Predictor(guidance=g, model=m, sched=DiffusionSchedule.create("linear", T, device="cpu"), mc_trials=2,
              ddim_steps=5, device="cpu").save(str(root / "artifact"))
    rc = export_main(["--artifact", str(root / "artifact"), "--out", str(root / "bundle"),
                      "--preset", "fast", "--max_batch", "2", "--device", "cpu"])
    return rc, str(root / "artifact"), ExportedPredictor.load(str(root / "bundle"), device="cpu")


def test_export_bundle_cli(fast_bundle):
    rc, _, served = fast_bundle
    assert rc == 0
    assert sorted(served.programs) == [1, 2]
    assert served.settings["ddim_steps"] == 10 and served.settings["use_int8"]
    assert np.isfinite(served.predict(_images(6, 1))["probs"]).all()


def test_bundle_carries_the_int8_run_weights(fast_bundle):
    """The fast bundle carries the resident int8 forms in place of the float
    weights they replace: lin2/lin3, enc_lin1 (use_int8_encode) and the
    mapping heads' linear1; and serves as the live fast predictor does."""
    _, artifact, served = fast_bundle
    w = served.weights
    for name in ("q_lin2_w", "q_lin3_w", "q_enc_w", "q_head0_w"):
        assert w[name].dtype == torch.int8, name
    for name in ("model.lin2.linear.weight", "model.enc_lin1.weight", "guidance.mlps.0.layers.0.weight"):
        assert name not in w, name
    assert w["model.enc_lin2.weight"].dtype == torch.float32
    live = Predictor.load(artifact, preset="fast", device="cpu")
    want = live.predict(_images(1, 2), generator=_gen(2))
    got = served.predict(_images(1, 2), generator=_gen(2))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _op_cases():
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    m, r, k, n = 2, 5, 32, 16
    x, w, a, c = t(m, r, k), t(m, k, n), t(m, n), t(m, n)
    h = x.abs()
    w_q, s = quantize_weight(t(m, k, n))
    colsum = w_q.sum(1, dtype=torch.int32).float()
    qkv = t(2, 7, 3, 2, 16)
    f, y_in, w1, a1, c1 = t(m, r, k), t(m, r, 4), t(m, 4, k), t(m, k), t(m, k)
    return {
        "fused_linear_act": (K.fused_linear_act_plain, (x, w, a, c, t(m, r, n))),
        "fused_linear_act-no-gate": (K.fused_linear_act_plain, (x, w, a, c, None)),
        "flash_attention": (K.flash_attention_plain, (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])),
        "int8_linear_softplus": (K.int8_linear_softplus_plain, (x, x.abs().amax(-1, keepdim=True), w_q, s, c, None)),
        "int8_linear_softplus-zero-point": (K.int8_linear_softplus_plain,
                                            (h, h.amax(-1, keepdim=True), w_q, s, c, colsum)),
        "int8_lin1": (K.int8_lin1_plain, (f, y_in, w1, a1, c1)),
        "int8_eps_l12": (K.int8_eps_l12_plain, (f, y_in, w1, a1, c1, w_q, s, c)),
        "int8_eps_l34": (K.int8_eps_l34_plain, (h, h.amax(-1, keepdim=True), w_q, s, c, colsum, t(m, n, 2))),
    }


OP_CASES = sorted(_op_cases())


@pytest.mark.parametrize("case", OP_CASES)
def test_op_passes_opcheck_and_runs_the_plain_version_on_the_cpu(case):
    plain, args = _op_cases()[case]
    op = getattr(torch.ops.ladine_tpu_torch, case.split("-")[0])
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result
    got, want = op(*args), plain(*args)
    for g_, w_ in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g_, w_)
