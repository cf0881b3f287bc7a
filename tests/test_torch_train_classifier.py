"""The port's stage-1 trainers against ``ladine_tpu/train/classifier_trainer.py``
on the CPU, at the widths of ``configs/synthetic_tiny.yml`` (ViT: images
32 x 32, patch 8, embed 32, 5 blocks, 2 heads; MLPs 512 -> 32 -> 16 -> 8 -> 2;
batch 16).

Each step starts both sides from the same JAX train state
(``utils/convert.py::train_state_from_jax``) in float32: losses and
accuracies agree to rel 1e-5, Adam's moments and count to abs 1e-5, the
step's gradient (read off the moments) to 1e-4 of JAX's in norm, and the
new parameters to abs 1e-5 but 6.4 lr where the step's gradient is at the
noise floor (|g| < 1e-6), for at most 1e-3 of a leaf
(``tests/torch_parity.py::assert_adam_step``). The key thirds of the qkv
biases have an exact gradient of zero (softmax does not see a constant
added to every key's score) and are left out of that count. The ViT
forward goes through K3's op (its plain version on the CPU) and K3's gradient is
its registered VJP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladine_tpu.models import ViT as JaxViT
from ladine_tpu.models.mlp import MappingMLP as JaxMLP
from ladine_tpu.train import classifier_trainer as JC
from ladine_tpu.train.optim import make_optimizer as jax_make_optimizer
from ladine_tpu.train.optim import step_decay as jax_step_decay
from ladine_tpu_torch.models import MappingMLP, ViT
from ladine_tpu_torch.train import classifier_trainer as C
from ladine_tpu_torch.train.optim import make_optimizer, step_decay
from ladine_tpu_torch.utils import train_state_from_jax, vit_from_flax
from torch_parity import assert_adam_step, key_bias_slices, t2n

B, IMG = 16, 32
VIT = dict(num_classes=2, img_size=IMG, patch_size=8, embed_dim=32, depth=5, num_heads=2)
HIDDEN = (32, 16, 8)
TAP_DIM = (IMG // 8) ** 2 * 32


def port_vit():
    return ViT(**VIT, device="cpu")


def batch(rng):
    return rng.random((B, IMG, IMG, 3), dtype=np.float32), rng.integers(0, 2, B)


def assert_train_step(port, old_jax, new_jax, kind, lr):
    old, ref = train_state_from_jax(old_jax, kind), train_state_from_jax(new_jax, kind)
    assert_adam_step(port.params, port.opt_state["mu"], old.opt_state["mu"], ref.opt_state["mu"], ref.params, lr,
                     lead=0 if kind == "vit" else 1, zero_grad=key_bias_slices(port.params))
    for slot in ("mu", "nu"):
        for k, v in ref.opt_state[slot].items():
            np.testing.assert_allclose(t2n(port.opt_state[slot][k]), t2n(v), rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(port.opt_state["count"].numpy(), ref.opt_state["count"].numpy())
    np.testing.assert_array_equal(port.step.numpy(), ref.step.numpy())


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits, labels = rng.standard_normal((3, 5, 4)).astype(np.float32), rng.integers(0, 4, (3, 5))
    want = JC.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(C.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))),
                               float(want), rtol=1e-6)


@pytest.mark.parametrize("name", ["AdamW", "Adam"])
def test_vit_train_and_eval_steps_match_jax(name):
    """The reference's fine-tune optimizer (AdamW, wd 0.1, a StepLR; here
    StepLR(1, 0.5) at 2 steps an epoch, so the rate halves inside the run)
    and plain Adam."""
    lr = 1e-3
    wd = 0.1 if name == "AdamW" else 0.0
    tx = jax_make_optimizer(name, jax_step_decay(lr, 1, 0.5, 2), weight_decay=wd, grad_clip=None)
    opt = make_optimizer(name, step_decay(lr, 1, 0.5, 2), weight_decay=wd, grad_clip=None)
    jv = JaxViT(**VIT)
    js = JC.create_vit_state(jv, jax.random.PRNGKey(0), tx, image_size=IMG)
    jstep, jeval = jax.jit(JC.make_vit_train_step(jv, tx)), jax.jit(JC.make_vit_eval_step(jv))
    vit = port_vit()
    step, evaluate = C.make_vit_train_step(vit, opt), C.make_vit_eval_step(vit)
    rng = np.random.default_rng(1)
    for i in range(3):
        images, labels = batch(rng)
        port = train_state_from_jax(js, "vit")
        new, jl, jacc = jstep(js, images, labels)
        port, loss, acc = step(port, torch.from_numpy(images), torch.from_numpy(labels))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        np.testing.assert_allclose(float(acc), float(jacc), rtol=1e-5)
        assert_train_step(port, js, new, "vit", lr)
        js = new
    images, labels = batch(rng)
    params = train_state_from_jax(js, "vit").params
    assert float(evaluate(params, torch.from_numpy(images), torch.from_numpy(labels))) == \
        float(jeval(js.params, images, labels))


def test_create_vit_state_inits_a_float32_vit():
    vit = port_vit().bfloat16()
    st = C.create_vit_state(vit, torch.Generator().manual_seed(0), make_optimizer("AdamW", 1e-4, weight_decay=0.1),
                            device="cpu")
    assert all(v.dtype == torch.float32 for v in st.params.values())
    assert st.params.keys() == dict(vit.named_parameters()).keys() and int(st.step) == 0
    assert (st.params["cls_token"] == 0).all() and st.params["pos_embed"].std() < 0.05
    with pytest.raises(NotImplementedError, match="backbones"):
        C.create_vit_state(torch.nn.Linear(2, 2), torch.Generator(), make_optimizer(), device="cpu")


def test_vit_step_runs_k3s_vjp_once_a_block():
    """The registered backward of K3's op runs once for each block in a
    train step (``kernels.vjp_runs``, what ``chip_smoke.py`` reads on the
    card), and an eval step runs none."""
    from ladine_tpu_torch.kernels import vjp_runs

    vit = port_vit()
    opt = make_optimizer("AdamW", 1e-4, weight_decay=0.1, grad_clip=None)
    state = C.create_vit_state(vit, torch.Generator().manual_seed(0), opt, device="cpu")
    images, labels = (torch.from_numpy(a) for a in batch(np.random.default_rng(2)))
    before = vjp_runs["flash_attention"]
    state, _, _ = C.make_vit_train_step(vit, opt)(state, images, labels)
    assert vjp_runs["flash_attention"] - before == VIT["depth"]
    C.make_vit_eval_step(vit)(state.params, images, labels)
    assert vjp_runs["flash_attention"] - before == VIT["depth"]


@pytest.fixture(scope="module")
def frozen_vit():
    jv = JaxViT(**VIT)
    vparams = jax.jit(jv.init)(jax.random.PRNGKey(5), jnp.zeros((1, IMG, IMG, 3)))["params"]
    vit = port_vit()
    vit.load_state_dict(vit_from_flax({"params": jax.tree.map(np.asarray, vparams)}))
    return jv, vparams, vit


@pytest.mark.parametrize("members", [None, (1, 3)], ids=["all5", "members13"])
def test_mapping_train_and_eval_steps_match_jax(frozen_vit, members):
    jv, vparams, vit = frozen_vit
    lr = 5e-4
    tx = jax_make_optimizer("Adam", jax_step_decay(lr, 20, 0.5, 2))
    opt = make_optimizer("Adam", step_decay(lr, 20, 0.5, 2))
    jm = JaxMLP(num_classes=2, hidden_dims=HIDDEN)
    js = JC.create_mapping_states(jm, jax.random.PRNGKey(1), tx, 5, num_patches=16, embed_dim=32,
                                  member_indices=members)
    jstep = jax.jit(JC.make_mapping_train_step(jv, vparams, jm, tx, 5, member_indices=members))
    jeval = jax.jit(JC.make_mapping_eval_step(jv, vparams, jm, 5, member_indices=members))
    mlp = MappingMLP(TAP_DIM, 2, HIDDEN, device="meta")
    step = C.make_mapping_train_step(vit, mlp, opt, 5, member_indices=members)
    evaluate = C.make_mapping_eval_step(vit, mlp, 5, member_indices=members)
    rng = np.random.default_rng(2)
    for i in range(3):
        images, labels = batch(rng)
        port = train_state_from_jax(js, "mapping")
        new, jl, jacc = jstep(js, images, labels)
        port, losses, accs = step(port, torch.from_numpy(images), torch.from_numpy(labels))
        np.testing.assert_allclose(t2n(losses), np.asarray(jl), rtol=1e-5)
        np.testing.assert_allclose(t2n(accs), np.asarray(jacc), rtol=1e-5)
        assert_train_step(port, js, new, "mapping", lr)
        js = new
    images, labels = batch(rng)
    got = evaluate(train_state_from_jax(js, "mapping").params, torch.from_numpy(images), torch.from_numpy(labels))
    np.testing.assert_array_equal(t2n(got), np.asarray(jeval(js.params, images, labels)))


def test_mapping_subset_initializes_as_the_full_stack():
    mlp = MappingMLP(TAP_DIM, 2, HIDDEN, device="meta")
    opt = make_optimizer("Adam", 1e-3)
    full = C.create_mapping_states(mlp, torch.Generator().manual_seed(3), opt, 5, device="cpu")
    sub = C.create_mapping_states(mlp, torch.Generator().manual_seed(3), opt, 5, member_indices=(1, 3), device="cpu")
    for k, v in sub.params.items():
        assert v.shape[0] == 2 and torch.equal(v, full.params[k][[1, 3]]), k
    assert sub.step.shape == (2,) and sub.opt_state["count"].shape == (2,)
    with pytest.raises(ValueError, match="increase"):
        C.make_mapping_train_step(port_vit(), mlp, opt, 5, member_indices=(3, 1))
