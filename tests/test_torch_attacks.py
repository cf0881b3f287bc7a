"""ladine_tpu_torch's white-box attacks against ladine_tpu's on the CPU.

The guidance's ``forward`` (every head), ``vit_logits`` and ``tap_logits``
against the JAX ``SEViTGuidance``'s on the same weights, 1e-5.

K3's gradient: ``torch.autograd.gradcheck`` of the attention op in float64,
``opcheck`` with inputs that require grad, and the cross-entropy gradient of
the port's ``vit_logits`` against ``jax.grad`` of the JAX ``vit_logits``
(its einsum attention) on the same weights, 1e-5.

Each attack runs against the same tiny ViT on both sides (float32), on the
deterministic path or from the same injected start, at the tolerances of
``tests/test_attack_oracle.py``: FGSM 1e-5; PGD, BIM, LinfBIM and L2PGD
1e-4; CW (4 x 120 steps) 5e-3; APGD at 20 iterations 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ladine_tpu import attacks as jat
from ladine_tpu.models import SEViTGuidance as JaxGuidance
from ladine_tpu_torch import attacks as tat
from ladine_tpu_torch.kernels import flash_attention, flash_attention_plain
from ladine_tpu_torch.models import SEViTGuidance
from ladine_tpu_torch.utils import guidance_from_flax
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

G = dict(num_classes=2, num_members=3, vit_depth=3, img_size=16, patch_size=8, embed_dim=16,
         num_heads=2, mlp_hidden_dims=(16, 8, 8))
B, EPS, L2_EPS = 3, 0.03, 0.5


@pytest.fixture(scope="module")
def vit():
    jg = JaxGuidance(**G)
    gvars = jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3))))
    g = SEViTGuidance(**G, device="cpu")
    g.load_state_dict(guidance_from_flax(gvars))
    jfn = jax.jit(lambda x: jg.apply(gvars, x, method="vit_logits"))
    x = np.random.default_rng(0).random((B, 16, 16, 3), dtype=np.float32)
    labels = np.array(jnp.argmax(jfn(jnp.asarray(x)), -1), np.int64)  # clean predictions: attacks move them
    return dict(jfn=jfn, tfn=g.vit_logits, g=g, x=x, labels=labels, jg=jg, gvars=gvars)


@pytest.mark.parametrize("method", ["__call__", "vit_logits", "tap_logits"])
def test_guidance_heads_match_jax(vit, method):
    want = vit["jg"].apply(vit["gvars"], jnp.asarray(vit["x"]), method=method)
    got = getattr(vit["g"], "forward" if method == "__call__" else method)(torch.from_numpy(vit["x"]))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_attention_gradcheck_float64():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 5, 3, 4, generator=gen, dtype=torch.float64, requires_grad=True)
               for _ in range(3))
    assert torch.autograd.gradcheck(flash_attention, (q, k, v))


def test_attention_opcheck_with_grad():
    gen = torch.Generator().manual_seed(1)
    qkv = torch.randn(2, 7, 3, 2, 8, generator=gen).requires_grad_(True)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    torch.library.opcheck(torch.ops.ladine_tpu_torch.flash_attention.default, (q, k, v))


def test_attention_gradient_equals_autograd_of_the_plain_version():
    gen = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(2, 9, 3, 8, generator=gen, requires_grad=True) for _ in range(3))
    d_out = torch.randn(2, 9, 3, 8, generator=gen)
    got = torch.autograd.grad(flash_attention(q, k, v), (q, k, v), d_out)
    want = torch.autograd.grad(flash_attention_plain(q, k, v), (q, k, v), d_out)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_vit_logits_ce_gradient_matches_jax_grad(vit):
    x, labels = vit["x"], vit["labels"]

    def loss(xx):
        logp = jax.nn.log_softmax(vit["jfn"](xx), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], axis=-1))

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    xx = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(F.cross_entropy(vit["tfn"](xx), torch.from_numpy(labels)), xx)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.abs(want).max() > 1e-3


def _pair(vit, name, jax_fn, torch_fn):
    x, labels = vit["x"], vit["labels"]
    want, want_ok = jax_fn(vit["jfn"], jnp.asarray(x), jnp.asarray(labels))
    got, got_ok = torch_fn(vit["tfn"], torch.from_numpy(x), torch.from_numpy(labels))
    return np.asarray(want), np.asarray(want_ok), got.numpy(), got_ok.numpy()


def _linf_start(key):
    return np.array(jax.random.uniform(key, (B, 16, 16, 3), jnp.float32, -EPS, EPS))


def _l2_start(key, x):
    """The JAX l2pgd's random start before its clip."""
    k_dir, k_rad = jax.random.split(key)
    u = jax.random.normal(k_dir, x.shape, jnp.float32)
    u = u / jnp.maximum(jnp.sqrt(jnp.sum(u**2, axis=(1, 2, 3), keepdims=True)), 1e-12)
    r = jax.random.uniform(k_rad, (x.shape[0], 1, 1, 1)) ** (1.0 / x[0].size)
    return np.array(jnp.asarray(x) + L2_EPS * r * u)


KEY = jax.random.PRNGKey(9)
CASES = {
    "FGSM": (1e-5, lambda f, x, y: jat.fgsm(f, x, y, EPS),
             lambda f, x, y, vit: tat.fgsm(f, x, y, EPS)),
    "PGD": (1e-4, lambda f, x, y: jat.pgd(f, x, y, EPS, KEY),
            lambda f, x, y, vit: tat.pgd(f, x, y, EPS, x_init=x + torch.from_numpy(_linf_start(KEY)))),
    "LinfBIM": (1e-4, lambda f, x, y: jat.linf_bim(f, x, y, EPS),
                lambda f, x, y, vit: tat.linf_bim(f, x, y, EPS)),
    "BIM": (1e-4, lambda f, x, y: jat.l2_bim(f, x, y, L2_EPS),
            lambda f, x, y, vit: tat.l2_bim(f, x, y, L2_EPS)),
    "L2PGD": (1e-4, lambda f, x, y: jat.l2pgd(f, x, y, L2_EPS, KEY),
              lambda f, x, y, vit: tat.l2pgd(f, x, y, L2_EPS, x_init=torch.from_numpy(_l2_start(KEY, vit["x"])))),
    "APGD": (1e-4, lambda f, x, y: jat.apgd_ce(f, x, y, EPS, KEY, n_iter=20),
             lambda f, x, y, vit: tat.apgd_ce(f, x, y, EPS, n_iter=20,
                                              x_init=x + torch.from_numpy(_linf_start(KEY)))),
}


@pytest.mark.parametrize("name", list(CASES))
def test_attack_matches_jax(vit, name):
    tol, jfn, tfn = CASES[name]
    want, want_ok, got, got_ok = _pair(vit, name, jfn, lambda f, x, y: tfn(f, x, y, vit))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_array_equal(got_ok, want_ok)
    assert np.abs(got - vit["x"]).max() > 1e-3  # the attack moved the images


@pytest.mark.parametrize("epsilon", [None, 0.3], ids=["unclipped", "eps-clipped"])
def test_cw_matches_jax(vit, epsilon):
    kw = dict(binary_search_steps=4, steps=120, stepsize=0.01, epsilon=epsilon)
    want, want_ok, got, got_ok = _pair(vit, "CW", lambda f, x, y: jat.cw_l2(f, x, y, **kw),
                                       lambda f, x, y: tat.cw_l2(f, x, y, **kw))
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)
    np.testing.assert_array_equal(got_ok, want_ok)


def test_checkpoints_match_jax():
    from ladine_tpu.attacks.autopgd import _checkpoints as jax_checkpoints
    from ladine_tpu_torch.attacks.autopgd import _checkpoints

    for n in (1, 5, 20, 100):
        np.testing.assert_array_equal(_checkpoints(n), jax_checkpoints(n))


def test_make_attack_routes_the_reference_modes(vit, monkeypatch):
    import ladine_tpu_torch.attacks as A

    assert A.ATTACKS == jat.ATTACKS
    seen = {}
    for fn in ("fgsm", "pgd", "l2_bim", "linf_bim", "l2pgd", "cw_l2", "apgd_ce"):
        monkeypatch.setattr(A, fn, lambda *a, _n=fn, **kw: seen.setdefault(_n, (a, kw)) and (a[1], None))
    x, y = torch.from_numpy(vit["x"]), torch.from_numpy(vit["labels"])
    for name in A.ATTACKS:
        A.apply_attack(A.make_attack(name, EPS, vit["tfn"]), x, y)
    assert sorted(seen) == ["apgd_ce", "cw_l2", "fgsm", "l2_bim", "l2pgd", "linf_bim", "pgd"]
    assert seen["cw_l2"][1]["epsilon"] == EPS
    seen.clear()
    A.make_attack("CW", 0.0, vit["tfn"])(x, y)
    assert seen["cw_l2"][1]["epsilon"] is None
    with pytest.raises(ValueError, match="unknown attack"):
        A.make_attack("Nope", EPS, vit["tfn"])


def test_random_starts_draw_from_the_generator(vit):
    x, y = torch.from_numpy(vit["x"]), torch.from_numpy(vit["labels"])
    for fn in (tat.pgd, tat.l2pgd):
        a, _ = fn(vit["tfn"], x, y, EPS, torch.Generator().manual_seed(3), steps=1)
        b, _ = fn(vit["tfn"], x, y, EPS, torch.Generator().manual_seed(3), steps=1)
        c, _ = fn(vit["tfn"], x, y, EPS, torch.Generator().manual_seed(4), steps=1)
        assert torch.equal(a, b) and not torch.equal(a, c)
    assert (a - x).pow(2).sum(dim=(1, 2, 3)).sqrt().max() <= EPS + 1e-6  # l2pgd stays in its ball
