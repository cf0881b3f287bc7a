"""Shared helpers of the tests that hold ladine_tpu_torch against ladine_tpu.

Data crosses between the frameworks as numpy arrays. The JAX samplers draw
their noise from ``jax.random``; the helpers here rebuild those exact draws
so that they can be injected into the port's samplers.
"""

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
