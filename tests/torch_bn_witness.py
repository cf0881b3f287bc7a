"""How far the port's deep train-mode BatchNorm chains are from JAX's, in
float32 and in float64 on both sides, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_bn_witness.py

For ResNet50 and EfficientNetV2-l (width 0.125, depth 0.15) at three
image sizes and batches, on the flax module's weights (every leaf
perturbed) carried by ``utils/convert.py``, it prints:

* the train-mode forward's max abs error over max|ref| in float32, beside
  how far JAX itself moves when its input moves one float32 ulp;
* the same in float64 (``jax.enable_x64``, the port's module ``.double()``);
* for one AdamW train step from the same JAX state, the worst gradient gap
  of a leaf in norm (read off Adam's first moments), in float32 and in
  float64 (EfficientNetV2's leaves with an exact zero gradient, the
  ``bn3`` biases the tests name, left out).

A gap that closes in float64 is rounding, not a port fault; this is the
witness behind the float64 cases of ``tests/test_torch_backbones.py`` and
``tests/test_torch_encoders.py``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ladine_tpu.models import backbones as JB  # noqa: E402
from ladine_tpu.models import encoders as JE  # noqa: E402
from ladine_tpu.train import classifier_trainer as JC  # noqa: E402
from ladine_tpu.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from ladine_tpu_torch.models import backbones as PB  # noqa: E402
from ladine_tpu_torch.models import encoders as PE  # noqa: E402
from ladine_tpu_torch.train import classifier_trainer as C  # noqa: E402
from ladine_tpu_torch.train.optim import make_optimizer  # noqa: E402
from ladine_tpu_torch.utils import module_from_flax, train_state_from_jax  # noqa: E402
from torch_parity import perturbed, to_float64  # noqa: E402

NETS = {
    "resnet50": (lambda: JE.ResNet(num_classes=3, arch="resnet50"), lambda: PE.ResNet(3, "resnet50")),
    "efficientnetv2-l": (
        lambda: JB.EfficientNetV2(num_classes=3, variant="l", width_mult=0.125, depth_mult=0.15),
        lambda: PB.EfficientNetV2(3, "l", width_mult=0.125, depth_mult=0.15, device="cpu")),
}
SIZES = ((16, 8), (32, 16), (64, 16))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def forward_gaps(make_j, make_p, img, batch):
    x = np.random.default_rng(1).random((batch, img, img, 3)).astype(np.float32)
    jmod = make_j()
    v = perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x)), scale=0.02)
    mod = make_p()
    mod.load_state_dict(module_from_flax(v))
    out = {}
    for wide in (False, True):
        with jax.enable_x64(wide):
            vv, xx = (to_float64(v), x.astype(np.float64)) if wide else (v, x)
            train = jax.jit(lambda x: jmod.apply(vv, x, train=True, mutable=["batch_stats"])[0])
            want = np.asarray(train(jnp.asarray(xx)))
            got = _np((mod.double() if wide else mod)(torch.from_numpy(xx), train=True))
            out["f64" if wide else "f32"] = np.abs(got - want).max() / np.abs(want).max()
            if not wide:
                moved = np.asarray(train(jnp.asarray(np.nextafter(x, np.float32(np.inf)))))
                out["jax_ulp"] = np.abs(moved - want).max() / np.abs(want).max()
    return out


def step_gaps(make_j, make_p, img, batch):
    lr = 1e-3
    jmod = make_j()
    js = JC.create_vit_state(jmod, jax.random.PRNGKey(0), jax_make_optimizer("AdamW", lr, weight_decay=0.1,
                                                                            grad_clip=None), image_size=img)
    rng = np.random.default_rng(4)
    images, labels = rng.random((batch, img, img, 3)), rng.integers(0, 3, batch)
    out = {}
    for wide in (False, True):
        with jax.enable_x64(wide):
            tx = jax_make_optimizer("AdamW", lr, weight_decay=0.1, grad_clip=None)
            j = js.replace(params=to_float64(js.params), batch_stats=to_float64(js.batch_stats),
                           opt_state=to_float64(js.opt_state)) if wide else js
            ims = images if wide else images.astype(np.float32)
            new = jax.jit(JC.make_vit_train_step(jmod, tx))(j, ims, labels)[0]
        module = make_p().to(torch.float64 if wide else torch.float32).to("meta")
        opt = make_optimizer("AdamW", lr, weight_decay=0.1, grad_clip=None)
        port = C.make_vit_train_step(module, opt)(train_state_from_jax(j, "vit"), torch.from_numpy(ims),
                                                  torch.from_numpy(labels))[0]
        ref = train_state_from_jax(new, "vit").opt_state["mu"]
        out["f64" if wide else "f32"] = max(
            float((port.opt_state["mu"][k].double() - v.double()).norm() / v.double().norm())
            for k, v in ref.items() if not k.endswith("bn3.bias") and float(v.double().norm()) > 0)
    return out


def main():
    torch.set_num_threads(4)
    print("net, image, batch: train-mode forward max|err| / max|ref| in f32 (JAX's own one-ulp move) and f64; "
          "step gradient's worst leaf gap in norm, f32 and f64")
    for name, (make_j, make_p) in NETS.items():
        for img, batch in SIZES:
            f = forward_gaps(make_j, make_p, img, batch)
            s = step_gaps(make_j, make_p, img, batch)
            print(f"{name}, {img} x {img}, {batch}: forward {f['f32']:.2e} (JAX {f['jax_ulp']:.2e}), "
                  f"{f['f64']:.2e}; gradient {s['f32']:.2e}, {s['f64']:.2e}", flush=True)


if __name__ == "__main__":
    main()
