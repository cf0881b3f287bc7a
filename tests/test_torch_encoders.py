"""The port's encoders (``models/encoders.py``) and every
``ConditionalModel`` arch against ``ladine_tpu`` on the CPU.

Each module runs on the flax module's weights (every leaf perturbed, so no
layout mistake hides behind a zero or a one), carried by
``utils/convert.py::module_from_flax`` / ``members_from_flax``: a
train-mode call (its output and the new running statistics, flax's
``mutable=["batch_stats"]``), then an eval-mode call on those statistics,
then the bridge back to flax, bit for bit. ``ConditionalModel``: the
encode/eps split of the eval forward, and the train-mode forward with the
y-branch's statistics, for each arch; an unknown arch raises in both.

Tolerances: max abs error <= 1e-5 on the linear paths and <= 1e-4 x
max|ref| where a conv runs (oneDNN and XLA sum in other orders); measured
~1e-7 and ~1e-6 x max|ref| in float32. New running statistics as
``tests/torch_parity.py::assert_batch_stats_close`` holds them (1e-4 of
the layer's scale). A train-mode call of a deep BatchNorm net renormalizes
every layer on the batch's statistics, so float32 rounding compounds: the
``resnet50`` arch at 32 x 32, batch 8, differs from JAX by ~8e-4 x
max|ref| in float32 (JAX from itself by ~2e-4 when its input moves one
ulp), at any image size tried up to 64 x 64 at batch 16. Its train-mode
call is therefore held in float64 on both sides (``jax.enable_x64``, the
port's model ``.double()``), where it agrees to ~3e-12 x max|ref|: the
function is JAX's, and the float32 gap is rounding
(``tests/torch_bn_witness.py``). Every other arch and encoder is held in
float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladine_tpu.models import ConditionalModel as JaxConditionalModel
from ladine_tpu.models import encoders as J
from ladine_tpu_torch.models import ConditionalModel
from ladine_tpu_torch.models import encoders as P
from ladine_tpu_torch.utils import members_from_flax, members_to_flax, module_from_flax, module_to_flax
from torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    assert_batch_stats_close, one_torch_thread, perturbed as _perturb, to_float64)

B = 8


def _close(got, want, conv: bool):
    want = np.asarray(want)
    atol = 1e-4 * float(np.abs(want).max()) if conv else 1e-5
    np.testing.assert_allclose(got.detach().cpu().double().numpy(), want, rtol=0, atol=atol)


def _tree_equal(a, b):
    jax.tree.map(lambda x, y: np.testing.assert_array_equal(np.asarray(x), np.asarray(y)), a, b)


ENCODERS = {
    "SimpleEncoder": (lambda: J.SimpleEncoder(out_dim=6), lambda: P.SimpleEncoder(8 * 8 * 3, 6), (8, 8, 3), False),
    "LeNet": (lambda: J.LeNet(num_classes=5), lambda: P.LeNet(5, (32, 32, 3)), (32, 32, 3), True),
    "LeNet5": (lambda: J.LeNet5(num_classes=5), lambda: P.LeNet5(5, (28, 28, 1)), (28, 28, 1), True),
    "FashionCNN": (lambda: J.FashionCNN(out_dim=5), lambda: P.FashionCNN(5, (28, 28, 1)), (28, 28, 1), True),
    "FashionCNN-guidance": (lambda: J.FashionCNN(out_dim=5, use_for_guidance=True),
                            lambda: P.FashionCNN(5, (28, 28, 1), use_for_guidance=True), (28, 28, 1), True),
    "SimNet": (lambda: J.SimNet(), lambda: P.SimNet(3), (20, 20, 3), True),
    "ResNet18": (lambda: J.ResNet(num_classes=3, arch="resnet18"), lambda: P.ResNet(3, "resnet18"), (16, 16, 3), True),
}


@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_matches_flax_in_train_and_eval_mode(name):
    make_j, make_p, shape, conv = ENCODERS[name]
    x = np.random.default_rng(1).standard_normal((B,) + shape).astype(np.float32)
    jmod = make_j()
    variables = _perturb(jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    mod = make_p().to(torch.float32)
    mod.load_state_dict(module_from_flax(variables))
    xt = torch.from_numpy(x)
    if "batch_stats" in variables:
        train = jax.jit(lambda x: jmod.apply(variables, x, train=True, mutable=["batch_stats"]))
        want, mutated = train(jnp.asarray(x))
        _close(mod(xt, train=True), want, conv)
        stats = P.pop_batch_stats(mod)
        ref = module_from_flax({"params": {}, "batch_stats": jax.tree.map(np.asarray, mutated["batch_stats"])})
        assert P.pop_batch_stats(mod) == {}
        assert_batch_stats_close(stats, ref)
        variables = {**variables, "batch_stats": jax.tree.map(np.asarray, mutated["batch_stats"])}
        mod.load_state_dict(module_from_flax(variables))
    _close(mod(xt), jmod.apply(variables, jnp.asarray(x)), conv)
    _tree_equal(module_to_flax(mod.state_dict()), variables)
    if name == "ResNet18":
        feats = jmod.apply(variables, jnp.asarray(x), return_features=True)
        _close(mod(xt, return_features=True), feats, conv)


def test_trajectory_classifier_matches_flax():
    jmod = J.TrajectoryClassifier(num_classes=3, feature_dim=12, seq_len=4, d_model=10, num_heads=2, num_layers=2)
    rng = np.random.default_rng(2)
    traj = rng.standard_normal((B, 4, 10)).astype(np.float32)
    feat = rng.standard_normal((B, 3, 4)).astype(np.float32)
    variables = _perturb(jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(traj), jnp.asarray(feat)))
    mod = P.TrajectoryClassifier(3, 12, 4, 10, 2, 2)
    mod.load_state_dict(module_from_flax(variables))
    want = jmod.apply(variables, jnp.asarray(traj), jnp.asarray(feat))
    _close(mod(torch.from_numpy(traj), torch.from_numpy(feat)), want, conv=False)
    _tree_equal(module_to_flax(mod.state_dict()), variables)


def test_flax_same_padding_is_asymmetric_on_even_sizes():
    """A stride-2 3x3 ``SAME`` conv on an even size pads (0, 1), as flax."""
    import flax.linen as nn

    x = np.random.default_rng(3).standard_normal((2, 8, 8, 3)).astype(np.float32)
    for n, stride in ((8, 2), (7, 2), (8, 1)):
        conv = nn.Conv(4, (3, 3), strides=(stride, stride), padding="SAME", use_bias=False)
        v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x[:, :n, :n]))
        ours = P.FlaxConv(3, 4, 3, stride, same=True, bias=False)
        ours.load_state_dict(module_from_flax(jax.tree.map(np.asarray, v)))
        _close(ours(torch.from_numpy(x[:, :n, :n]).permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
               conv.apply(v, jnp.asarray(x[:, :n, :n])), conv=True)


# ----------------------------------------------------------- ConditionalModel

M, FEAT, Y, STEPS = 2, 8, 2, 11
ARCHS = {"linear": (6, 6, 3), "simple": (6, 6, 3), "lenet": (28, 28, 1), "lenet5": (28, 28, 1),
         "fashioncnn": (28, 28, 1), "resnet18": (16, 16, 3), "resnet50": (32, 32, 3)}


def _flat(arch):
    return arch in ("linear", "simple")


@pytest.fixture(scope="module", params=list(ARCHS))
def arch_pair(request):
    """M flax members of the arch (statistics pushed by one train-mode
    pass each), stacked, and the port's model on them."""
    from ladine_tpu.infer import stack_members

    arch = request.param
    shape = ARCHS[arch]
    data_dim = int(np.prod(shape))
    jm = JaxConditionalModel(data_dim=data_dim, feature_dim=FEAT, hidden_dim=FEAT, y_dim=Y, n_steps=STEPS, arch=arch)
    rng = np.random.default_rng(4)
    x = rng.random((B,) + shape).astype(np.float32)
    x = x.reshape(B, -1) if _flat(arch) else x
    y = rng.standard_normal((B, Y)).astype(np.float32)
    yh = rng.dirichlet([1.0, 1.0], B).astype(np.float32)

    @jax.jit
    def one(key):
        v = jm.init(key, x, y, jnp.asarray(3), yh)
        v = {"params": v["params"], "batch_stats": v["batch_stats"]}
        _, mut = jm.apply(v, x, y, jnp.asarray(3), yh, train=True, mutable=["batch_stats"])
        return {"params": v["params"], "batch_stats": mut["batch_stats"]}

    stacked = jax.tree.map(np.asarray, stack_members([one(jax.random.PRNGKey(i)) for i in range(M)]))
    stacked = {"params": _perturb(stacked["params"], 1, 0.02), "batch_stats": stacked["batch_stats"]}
    model = ConditionalModel(M, data_dim, FEAT, FEAT, Y, STEPS, device="cpu", arch=arch)
    model.load_state_dict(members_from_flax(stacked))
    return arch, jm, stacked, model


def _inputs(arch, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.random((B,) + ARCHS[arch]).astype(np.float32)
    y = rng.standard_normal((M, B, Y)).astype(np.float32)
    yh = rng.dirichlet([1.0, 1.0], (M, B)).astype(np.float32)
    return (x.reshape(B, -1) if _flat(arch) else x), y, yh


def test_conditional_model_eval_matches_flax(arch_pair):
    arch, jm, stacked, model = arch_pair
    x, y, yh = _inputs(arch)
    xt = torch.from_numpy(x)
    f = model.encode(xt)
    assert f.shape == (M, B, FEAT) and f.dtype == torch.float32
    eps = model.eps(f, torch.from_numpy(y), 6, torch.from_numpy(yh))
    torch.testing.assert_close(model(xt, torch.from_numpy(y), 6, torch.from_numpy(yh)), eps, rtol=0, atol=0)
    conv = arch not in ("linear", "simple")
    for i in range(M):
        v = jax.tree.map(lambda a: jnp.asarray(a[i]), stacked)
        ref_f = jm.apply(v, jnp.asarray(x), method="encode")
        _close(f[i], ref_f, conv)
        ref = jm.apply(v, ref_f, jnp.asarray(y[i]), jnp.asarray(6), jnp.asarray(yh[i]), method="eps")
        _close(eps[i], ref, conv)
    _tree_equal(members_to_flax(model.state_dict()), stacked)


def test_conditional_model_train_mode_matches_flax(arch_pair):
    """float32, and float64 on both sides for ``resnet50`` (the module
    docstring says why)."""
    import copy

    arch, jm, stacked, model = arch_pair
    x, y, yh = _inputs(arch, 6)
    t = np.random.default_rng(7).integers(0, STEPS, (M, B))
    wide = arch == "resnet50"
    if wide:
        model, stacked, x, y, yh = copy.deepcopy(model).double(), to_float64(stacked), *to_float64((x, y, yh))
    got, stats = model(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t), torch.from_numpy(yh),
                       train=True)
    assert got.dtype == (torch.float64 if wide else torch.float32)
    want_stats = []
    conv = arch not in ("linear", "simple")
    with jax.enable_x64(wide):
        for i in range(M):
            v = jax.tree.map(lambda a: jnp.asarray(a[i]), stacked)
            want, mut = jax.jit(lambda x: jm.apply(v, x, jnp.asarray(y[i]), jnp.asarray(t[i]), jnp.asarray(yh[i]),
                                                   train=True, mutable=["batch_stats"]))(jnp.asarray(x))
            assert want.dtype == (jnp.float64 if wide else jnp.float32)
            _close(got[i], want, conv)
            want_stats.append(jax.tree.map(np.asarray, mut["batch_stats"]))
    ref = members_from_flax({"params": stacked["params"],
                             "batch_stats": jax.tree.map(lambda *a: np.stack(a), *want_stats)})
    assert_batch_stats_close(stats, {k: v for k, v in ref.items() if k.endswith(("running_mean", "running_var"))})


def test_nhwc_archs_refuse_flat_images_and_unknown_archs_raise():
    model = ConditionalModel(1, 28 * 28, FEAT, FEAT, Y, STEPS, device="meta", arch="lenet")
    assert model.image_shape == (28, 28, 1)
    with pytest.raises(ValueError, match="serves the archs 'linear' and 'simple' only"):
        model.encode(torch.zeros(2, 28 * 28, device="meta"))
    with pytest.raises(ValueError, match="unknown encoder arch"):
        ConditionalModel(1, 12, FEAT, FEAT, Y, STEPS, device="meta", arch="vgg")
    jm = JaxConditionalModel(data_dim=12, feature_dim=FEAT, hidden_dim=FEAT, y_dim=Y, n_steps=STEPS, arch="vgg")
    with pytest.raises(ValueError, match="unknown encoder arch"):
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 12)), jnp.zeros((1, Y)), jnp.asarray(0), jnp.zeros((1, Y)))


def test_simple_arch_serves_through_the_predictor():
    """The JAX Predictor flattens images, so ``arch="simple"`` serves
    (``tests/test_serve_sharded.py``); the port's serves it too, eager and
    after save/load, equal."""
    import tempfile

    from ladine_tpu_torch.infer import Predictor
    from ladine_tpu_torch.models import SEViTGuidance, init_random_
    from ladine_tpu_torch.ops import DiffusionSchedule

    g = init_random_(SEViTGuidance(2, 2, 2, 8, 4, 16, 2, (16, 8, 8), device="cpu"), torch.Generator().manual_seed(0))
    model = init_random_(ConditionalModel(2, 8 * 8 * 3, FEAT, FEAT, Y, STEPS, device="cpu", arch="simple"),
                         torch.Generator().manual_seed(1))
    sched = DiffusionSchedule.create("linear", STEPS - 1, 1e-4, 0.02, device="cpu")
    pred = Predictor(guidance=g, model=model, sched=sched, mc_trials=3, ddim_steps=0, device="cpu",
                     use_int8_encode=True)
    images = np.random.default_rng(0).random((3, 8, 8, 3)).astype(np.float32)
    want = pred.predict(images, generator=torch.Generator().manual_seed(2))
    assert np.allclose(want["probs"].sum(-1), 1.0, atol=1e-5)
    with tempfile.TemporaryDirectory() as d:
        pred.save(d)
        back = Predictor.load(d, device="cpu")
        assert back.model.arch == "simple"
        got = back.predict(images, generator=torch.Generator().manual_seed(2))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
