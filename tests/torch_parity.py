"""Shared helpers of the tests that hold ladine_tpu_torch against ladine_tpu.

Data crosses between the frameworks as numpy arrays. The JAX samplers draw
their noise from ``jax.random``; the helpers here rebuild those exact draws
so that they can be injected into the port's samplers.
"""

import jax
import jax.numpy as jnp
import numpy as np
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
