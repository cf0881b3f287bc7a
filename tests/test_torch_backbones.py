"""The port's stage-1 backbones (``models/backbones.py``, the ResNets of
``models/encoders.py``) against ``ladine_tpu`` on the CPU.

* Forward on the flax module's weights (every leaf perturbed), carried by
  ``utils/convert.py::module_from_flax``: DeiT in both forms, GPSA (its
  ``rel_indices`` equal, its rows summing to one), ConViT with the cls
  token joining at block ``local_layers`` and in the degenerate case
  ``depth <= local_layers``, EfficientNetV2 s/m/l at width 0.125 and
  depth 0.15 in eval and train mode.
* One train step of each ``--model_arch`` backbone, from the same JAX
  ``TrainState`` (``train_state_from_jax``, which carries the
  ``batch_stats`` of the BatchNorm ones): the loss and accuracy to rel
  1e-5, the gradient, moments and new parameters as
  ``tests/torch_parity.py::assert_adam_step`` holds them, the new running
  statistics as ``assert_batch_stats_close`` does.
* ``train_transformer --demo`` for each of the seven archs in both
  packages: ``tests/test_torch_backbones_cli.py``.

Tolerances: max abs error <= 1e-4 x max|ref| (convs and attention sum in
other orders; measured ~1e-6 x max|ref| in float32). A train-mode
BatchNorm chain compounds float32 rounding: EfficientNetV2-l differs from
JAX by ~2e-4 x max|ref| in train mode, and ResNet50's step gradient by 5
to 8 % in norm at every size tried (16 x 16 at batch 8 up to 64 x 64 at
batch 16), while JAX itself moves ~1e-4 x max|ref| when its input moves
one float32 ulp. Those two are held in float64 on both sides
(``jax.enable_x64``, the port's module ``.double()``), where EfficientNetV2-l
agrees to ~1e-13 x max|ref| and ResNet50's step gradient to ~6e-8 in norm
(held to 1e-6): the function is JAX's, and the float32 gap is rounding
(``tests/torch_bn_witness.py`` prints both gaps at three sizes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladine_tpu.models import backbones as JB
from ladine_tpu.models import encoders as JE
from ladine_tpu.models import ViT as JaxViT
from ladine_tpu.train import classifier_trainer as JC
from ladine_tpu.train.optim import make_optimizer as jax_make_optimizer
from ladine_tpu_torch.models import ViT
from ladine_tpu_torch.models import backbones as PB
from ladine_tpu_torch.models import encoders as PE
from ladine_tpu_torch.train import classifier_trainer as C
from ladine_tpu_torch.train.optim import make_optimizer
from ladine_tpu_torch.utils import module_from_flax, module_to_flax, train_state_from_jax
from torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    GRAD_RTOL, assert_adam_step, assert_batch_stats_close, one_torch_thread, perturbed as _perturb, t2n, to_float64)

B, IMG = 4, 16
GEOM = dict(img_size=IMG, patch_size=4, embed_dim=16, depth=3, num_heads=2)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().cpu().double().numpy(), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


def _images(seed=1, n=B):
    return np.random.default_rng(seed).random((n, IMG, IMG, 3)).astype(np.float32)


BACKBONES = {
    "vit": (lambda: JaxViT(num_classes=3, **GEOM), lambda: ViT(3, **GEOM, device="cpu")),
    "deit": (lambda: JB.DeiT(num_classes=3, **GEOM), lambda: PB.DeiT(3, **GEOM, device="cpu")),
    "deit_distilled": (lambda: JB.DeiT(num_classes=3, distilled=True, **GEOM),
                       lambda: PB.DeiT(3, **GEOM, distilled=True, device="cpu")),
    "convit": (lambda: JB.ConViT(num_classes=3, local_layers=2, **GEOM),
               lambda: PB.ConViT(3, **GEOM, local_layers=2, device="cpu")),
    "convit_degenerate": (lambda: JB.ConViT(num_classes=3, local_layers=3, **GEOM),
                          lambda: PB.ConViT(3, **GEOM, local_layers=3, device="cpu")),
    "efficientnetv2": (lambda: JB.EfficientNetV2(num_classes=3, variant="s", width_mult=0.125, depth_mult=0.15),
                       lambda: PB.EfficientNetV2(3, "s", width_mult=0.125, depth_mult=0.15, device="cpu")),
    "resnet18": (lambda: JE.ResNet(num_classes=3, arch="resnet18"), lambda: PE.ResNet(3, "resnet18")),
    "resnet50": (lambda: JE.ResNet(num_classes=3, arch="resnet50"), lambda: PE.ResNet(3, "resnet50")),
}


@pytest.mark.parametrize("name", ["deit", "deit_distilled", "convit", "convit_degenerate"])
def test_transformer_backbones_match_flax(name):
    make_j, make_p = BACKBONES[name]
    x = _images()
    jmod = make_j()
    variables = _perturb(jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    mod = make_p()
    mod.load_state_dict(module_from_flax(variables))
    _close(mod(torch.from_numpy(x)), jax.jit(jmod.apply)(variables, jnp.asarray(x)))
    jax.tree.map(np.testing.assert_array_equal, module_to_flax(mod.state_dict()), variables)
    if name.startswith("convit"):
        assert (mod.cls_token is None) == (name == "convit_degenerate")


def test_gpsa_rel_indices_and_rows():
    np.testing.assert_array_equal(t2n(PB.GPSA.rel_indices(16)), JB.GPSA.rel_indices(16))
    gpsa = JB.GPSA(dim=16, num_heads=2)
    x = np.random.default_rng(2).standard_normal((B, 16, 16)).astype(np.float32)
    variables = _perturb(gpsa.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ours = PB.GPSA(16, 2)
    ours.load_state_dict(module_from_flax(variables))
    _close(ours(torch.from_numpy(x)), gpsa.apply(variables, jnp.asarray(x)))
    # the mixed attention is renormalized: a v of ones comes out as ones
    with torch.no_grad():
        ours.v.weight.zero_()
        ours.v.bias.fill_(1.0)
        ours.proj.weight.copy_(torch.eye(16))
        ours.proj.bias.zero_()
    torch.testing.assert_close(ours(torch.from_numpy(x)), torch.ones(B, 16, 16), rtol=0, atol=1e-6)


@pytest.mark.parametrize("variant", ["s", "m", "l"])
def test_efficientnetv2_matches_flax_in_eval_and_train_mode(variant):
    """Eval mode in float32; train mode in float32, and in float64 on both
    sides for ``l`` (the module docstring says why)."""
    x = _images(3)
    jmod = JB.EfficientNetV2(num_classes=3, variant=variant, width_mult=0.125, depth_mult=0.15)
    variables = _perturb(jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x)), scale=0.02)
    mod = PB.EfficientNetV2(3, variant, width_mult=0.125, depth_mult=0.15, device="cpu")
    mod.load_state_dict(module_from_flax(variables))
    _close(mod(torch.from_numpy(x)), jax.jit(jmod.apply)(variables, jnp.asarray(x)))
    jax.tree.map(np.testing.assert_array_equal, module_to_flax(mod.state_dict()), variables)
    wide = variant == "l"
    with jax.enable_x64(wide):
        v, xs = (to_float64(variables), x.astype(np.float64)) if wide else (variables, x)
        want, mut = jax.jit(lambda x: jmod.apply(v, x, train=True, mutable=["batch_stats"]))(jnp.asarray(xs))
    ours = mod.double() if wide else mod
    got = ours(torch.from_numpy(xs), train=True)
    assert got.dtype == (torch.float64 if wide else torch.float32) and want.dtype == xs.dtype
    _close(got, want)
    assert_batch_stats_close(PE.pop_batch_stats(ours),
                             module_from_flax({"batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])}))


def _zero_grad(params, module):
    """Elements whose exact gradient is zero: the key parts of the attention
    biases (softmax does not see a constant added to every key's score),
    GPSA's positional bias (the same for every key of a row), and in
    EfficientNetV2 the last BatchNorm bias of a block whose output reaches
    only 1x1 convs into train-mode BatchNorms (a pointwise expansion, the
    head; through residuals): the batch mean takes the constant out."""
    out = {}
    if isinstance(module, PB.EfficientNetV2):
        blocks = [getattr(module, n) for n in module.block_names]

        def absorbed(j):  # a constant added to block j's input vanishes
            if j == len(blocks):
                return True  # the head's 1x1 conv and BatchNorm
            b = blocks[j]
            return b.pointwise and (not b.residual or absorbed(j + 1))

        for j, name in enumerate(module.block_names):
            if absorbed(j + 1):
                out[f"{name}.bn3.bias"] = ...
    for k, v in params.items():
        if k.endswith("attn.qkv.bias"):
            out[k] = slice(v.shape[-1] // 3, 2 * v.shape[-1] // 3)
        elif k.endswith("attn.qk.bias"):
            out[k] = slice(v.shape[-1] // 2, None)
        elif k.endswith("attn.pos_proj.bias"):
            out[k] = ...
    return out


@pytest.mark.parametrize("name", ["vit", "deit", "deit_distilled", "convit", "efficientnetv2", "resnet18",
                                  "resnet50"])
def test_train_step_matches_jax(name):
    """float32, and float64 on both sides for ResNet50 (the module
    docstring says why), whose step gradient is then held to 1e-6 in norm."""
    lr = 1e-3
    tx = jax_make_optimizer("AdamW", lr, weight_decay=0.1, grad_clip=None)
    opt = make_optimizer("AdamW", lr, weight_decay=0.1, grad_clip=None)
    make_j, make_p = BACKBONES[name]
    jmod = make_j()
    js = JC.create_vit_state(jmod, jax.random.PRNGKey(0), tx, image_size=IMG)
    rng = np.random.default_rng(4)
    images, labels = rng.random((8, IMG, IMG, 3)).astype(np.float32), rng.integers(0, 3, 8)
    wide = name == "resnet50"
    with jax.enable_x64(wide):
        if wide:
            js = js.replace(params=to_float64(js.params), batch_stats=to_float64(js.batch_stats),
                            opt_state=to_float64(js.opt_state))
            images = images.astype(np.float64)
        new, jl, jacc = jax.jit(JC.make_vit_train_step(jmod, tx))(js, images, labels)
    port = train_state_from_jax(js, "vit")
    assert (port.batch_stats is None) == (js.batch_stats is None)
    module = make_p().to(torch.float64 if wide else torch.float32).to("meta")
    port, loss, acc = C.make_vit_train_step(module, opt)(port, torch.from_numpy(images), torch.from_numpy(labels))
    assert loss.dtype == (torch.float64 if wide else torch.float32)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(acc), float(jacc), rtol=1e-5)
    old, ref = train_state_from_jax(js, "vit"), train_state_from_jax(new, "vit")
    assert_adam_step(port.params, port.opt_state["mu"], old.opt_state["mu"], ref.opt_state["mu"], ref.params, lr,
                     zero_grad=_zero_grad(port.params, module), grad_rtol=1e-6 if wide else GRAD_RTOL)
    if ref.batch_stats is not None:
        assert_batch_stats_close(port.batch_stats, ref.batch_stats)
    correct = C.make_vit_eval_step(module)(port.params, torch.from_numpy(images), torch.from_numpy(labels),
                                           port.batch_stats)
    assert 0 <= float(correct) <= 8
