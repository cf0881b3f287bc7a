"""Shared helpers of the tests that hold ladine_tpu_torch against ladine_tpu.

Data crosses between the frameworks as numpy arrays. The JAX samplers draw
their noise from ``jax.random``; the helpers here rebuild those exact draws
so that they can be injected into the port's samplers.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def t2n(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def j2t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def jax_loop_noise(key, shape, n_draws: int) -> np.ndarray:
    """The draws of one JAX ``p_sample_loop``/``ddim_sample_loop`` call:
    ``key_init, key_scan = split(key)``, ``normal(key_init)``, then
    ``normal(split(key_scan, n_draws - 1)[i])``. Returns (n_draws, *shape)."""
    key_init, key_scan = jax.random.split(key)
    first = jax.random.normal(key_init, shape, jnp.float32)[None]
    steps = jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(
        jax.random.split(key_scan, n_draws - 1)
    )
    return np.asarray(jnp.concatenate([first, steps], axis=0))


def jax_ensemble_noise(key, members: int, trials: int, shape, n_draws: int) -> np.ndarray:
    """The draws of a JAX ``nested_ensemble_sample`` call: ``split(key, M)``
    per member, ``split(member_key, K)`` per trial, then one loop each.
    Returns (n_draws, M, K, *shape), the port's injected-noise layout."""
    out = np.empty((n_draws, members, trials) + tuple(shape), np.float32)
    for m, mk in enumerate(jax.random.split(key, members)):
        for k, tk in enumerate(jax.random.split(mk, trials)):
            out[:, m, k] = jax_loop_noise(tk, shape, n_draws)
    return out


def jax_folded_noise(key, members: int, trials: int, shape, n_draws: int) -> np.ndarray:
    """The draws of the JAX engine's ``use_int8_pallas`` path, which folds
    the trials into rows: ``split(key, M)`` per member, then one loop over
    a (trials, *shape) y. Returns (n_draws, M, K, *shape)."""
    out = np.empty((n_draws, members, trials) + tuple(shape), np.float32)
    for m, mk in enumerate(jax.random.split(key, members)):
        out[:, m] = jax_loop_noise(mk, (trials,) + tuple(shape), n_draws)
    return out


def jax_members(model, n: int, data_dim: int, key_base: int = 5):
    """n flax ConditionalModel variable trees with BatchNorm statistics
    pushed off their init values (one train-mode pass each), stacked on a
    leading member axis."""
    from ladine_tpu.infer import stack_members

    @jax.jit
    def one(key):
        ks = jax.random.split(key, 4)
        x = jax.random.normal(ks[0], (6, data_dim))
        y = jax.random.normal(ks[1], (6, model.y_dim))
        yhat = jax.nn.softmax(jax.random.normal(ks[2], (6, model.y_dim)))
        v = model.init(ks[3], x, y, jnp.asarray(3), yhat)
        _, mutated = model.apply(v, x, y, jnp.asarray(3), yhat, train=True,
                                 mutable=["batch_stats"])
        return {"params": v["params"], "batch_stats": mutated["batch_stats"]}

    members = [one(jax.random.PRNGKey(key_base + i)) for i in range(n)]
    return jax.tree.map(np.asarray, stack_members(members))


def jax_corruption_draws(key, shape, cover=(0.0, 0), crop=0.0, num_candidates: int = 32):
    """The draws of one JAX ``apply_corruptions(images, key, ...)`` call, in
    the port's ``draws`` layout: ``"noise"`` (the standard normals of
    ``add_noise``), ``"cover"`` (each image's and region's candidate tops and
    lefts, (B, n, num_candidates)) and ``"crop"`` (each image's top and left,
    (B,)). The JAX package splits the key into (noise, cover, crop), then
    per image, per region, and into (top, left)."""
    b, h, w, _ = shape
    k_noise, k_cover, k_crop = jax.random.split(key, 3)
    draws = {"noise": torch.from_numpy(np.array(jax.random.normal(k_noise, shape, jnp.float32)))}
    k, n = cover
    side = int((k * h * w) ** 0.5)
    if side and n:
        tops = np.empty((b, n, num_candidates), np.int64)
        lefts = np.empty_like(tops)
        for i, ki in enumerate(jax.random.split(k_cover, b)):
            for j, kj in enumerate(jax.random.split(ki, n)):
                kt, kl = jax.random.split(kj)
                tops[i, j] = np.asarray(jax.random.randint(kt, (num_candidates,), 0, h - side + 1))
                lefts[i, j] = np.asarray(jax.random.randint(kl, (num_candidates,), 0, w - side + 1))
        draws["cover"] = (torch.from_numpy(tops), torch.from_numpy(lefts))
    if crop > 0.0:
        size = int(w * (1.0 - crop))
        corners = np.empty((2, b), np.int64)
        for i, ki in enumerate(jax.random.split(k_crop, b)):
            kt, kl = jax.random.split(ki)
            corners[0, i] = int(jax.random.randint(kt, (), 0, h - size + 1))
            corners[1, i] = int(jax.random.randint(kl, (), 0, w - size + 1))
        draws["crop"] = (torch.from_numpy(corners[0]), torch.from_numpy(corners[1]))
    return draws


def jax_eval_draws(key, cfg, shape, members: int, n_draws: int):
    """The draws of one batch of the JAX ``make_eval_pipeline``: its key
    splits into (corrupt, attack, sample); returns the port's ``draws``
    (``"corrupt"`` and the sampler's ``"noise"``; the JAX ``use_int8_pallas``
    path folds the trials into rows) and the attack key."""
    k_corrupt, k_attack, k_sample = jax.random.split(key, 3)
    b = shape[0]
    rebuild = jax_folded_noise if cfg.use_int8_pallas else jax_ensemble_noise
    noise = rebuild(k_sample, members, cfg.mc_trials, (b, 2), n_draws)
    return {"corrupt": jax_corruption_draws(k_corrupt, shape, cfg.cover, cfg.crop),
            "noise": j2t(noise)}, k_attack


def jax_member_draws(key, n: int, num_timesteps: int, y_dim: int):
    """The draws of one JAX ``make_member_step`` call: ``k_t, k_e =
    split(key)``, ``antithetic_timesteps(k_t, ...)``, then ``normal(k_e,
    (n, y_dim))``. Returns (t (n,), noise (n, y_dim)) as tensors."""
    from ladine_tpu.ops.diffusion import antithetic_timesteps

    k_t, k_e = jax.random.split(key)
    t = np.asarray(antithetic_timesteps(k_t, n, num_timesteps))
    e = np.asarray(jax.random.normal(k_e, (n, y_dim), jnp.float32))
    return torch.from_numpy(t.astype(np.int64)), j2t(e)


def jax_multi_draws(key, members: int, n: int, num_timesteps: int, y_dim: int):
    """The draws of one JAX ``make_multi_member_step`` call (also inside
    the full and joint steps): ``split(key, M)``, then each member as
    :func:`jax_member_draws`. Returns (t (M, n), noise (M, n, y_dim))."""
    draws = [jax_member_draws(k, n, num_timesteps, y_dim) for k in jax.random.split(key, members)]
    return torch.stack([d[0] for d in draws]), torch.stack([d[1] for d in draws])


GRAD_RTOL = 1e-4  # the step's gradient, read off Adam's first moments, against JAX's
EXCUSED_MAX = 1e-3  # share of a leaf that may step apart at the gradient's noise floor


def key_bias_slices(params) -> dict:
    """The key thirds of every attention's fused qkv bias: softmax does not
    see a constant added to every key's score, so their exact gradient is
    zero (for :func:`assert_adam_step`'s ``zero_grad``)."""
    return {k: slice(v.shape[-1] // 3, 2 * v.shape[-1] // 3) for k, v in params.items()
            if k.endswith("attn.qkv.bias")}


def assert_adam_step(params, mu, mu_old, ref_mu, ref_params, lr, lead=0, zero_grad=None):
    """New parameters and first moments against JAX's after one Adam step
    (b1 = 0.9) from the same state, each leaf in ``lead`` leading stacked
    axes a member at a time:

    - the step's gradient, read off the first moments (g = (mu - 0.9
      mu_old) / 0.1), within GRAD_RTOL of JAX's in norm;
    - the new parameters to abs 1e-5, except where JAX's gradient is below
      1e-6: at that noise floor Adam's step g/(|g| + eps) turns a rounding
      difference of g into a step difference, so those elements are held
      to Adam's largest step twice over (2 x 3.2 lr), and at most
      EXCUSED_MAX of a leaf (at least one element) may use that room.

    ``zero_grad`` maps a leaf's name to the index of its elements whose
    exact gradient is zero (``...`` for all): JAX's gradient there must be
    at the noise floor, and they are left out of the gradient check and of
    the excused share. Prints each leaf's excused elements; returns the
    masks of the elements at the noise floor."""
    zero_grad = zero_grad or {}
    noisy, excused = {}, {}
    for k, v in ref_params.items():
        g_ref = (ref_mu[k] - 0.9 * mu_old[k]) / 0.1
        g_port = (mu[k] - 0.9 * mu_old[k]) / 0.1
        noisy[k] = g_ref.abs() < 1e-6
        diff = (params[k] - v).abs()
        assert diff.max() <= 2 * 3.2 * lr, (k, diff.max())
        zero = torch.zeros_like(noisy[k])
        if k in zero_grad:
            zero[(slice(None),) * lead + (zero_grad[k],)] = True
            assert noisy[k][zero].all(), (k, g_ref[zero].abs().max())
        used = noisy[k] & (diff > 1e-5) & ~zero
        excused[k] = int(used.sum())
        assert excused[k] <= max(1, EXCUSED_MAX * int((~zero).sum())), (k, excused[k], g_ref[used], diff[used])
        n = math.prod(g_ref.shape[:lead])
        g_ref, g_port = g_ref.masked_fill(zero, 0.0), g_port.masked_fill(zero, 0.0)
        gaps, norms = (g_port - g_ref).reshape(n, -1).norm(dim=-1), g_ref.reshape(n, -1).norm(dim=-1)
        assert (gaps <= GRAD_RTOL * norms).all(), (k, gaps, norms)
    print("elements stepped apart at the gradient's noise floor, outside the exact zeros: "
          + (", ".join(f"{k} {n} of {ref_params[k].numel()}" for k, n in excused.items() if n) or "none"))
    return noisy


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch ops on one thread for the module: these tests run many tiny ops
    (an attack's hundreds of steps on a tiny ViT), and with several test
    workers on the machine torch's default of one thread a core makes each
    op wait on the others' threads. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
