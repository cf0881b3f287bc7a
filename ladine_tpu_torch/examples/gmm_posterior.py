"""Statistical check of the trainer and the samplers together: CARD
posterior recovery on a 1-D Gaussian mixture.

Counterpart of ``examples/gmm_posterior.py``. On a two-component mixture
the class posterior p(y=1|x) is analytic
(``data.GaussianMixture1D.posterior``); a member trained on samples of the
mixture, with flat guidance so that the signal must flow through the
diffusion model, gives Monte-Carlo vote fractions that track it. The grid
is sampled in five rows: the ancestral chain and DDIM on the float32
member (K1 on the card), then on its bfloat16 hand-off the int8 eps with
bfloat16 rows (``use_int8_eps``, ``torch._int_mm``), K4
(``use_int8_pallas``) and K5 (``pallas_fuse_ends``). The MAE of each row
against the analytic posterior is the result; below 0.1 the machinery is
sound.

    python -m ladine_tpu_torch.examples.gmm_posterior [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ladine_tpu_torch.data import GaussianMixture1D
from ladine_tpu_torch.device import resolve_device
from ladine_tpu_torch.infer.engine import nested_ensemble_sample
from ladine_tpu_torch.kernels import launch_counts
from ladine_tpu_torch.models import ConditionalModel
from ladine_tpu_torch.ops import DiffusionSchedule, ddim_timesteps
from ladine_tpu_torch.train import (
    conditional_model_from_state,
    create_member_state,
    make_member_step,
    make_optimizer,
)

T = 100
BATCH = 128
# row: (bfloat16 hand-off, DDIM, use_int8_eps, use_int8_pallas, pallas_fuse_ends)
ROWS = {
    "ancestral": (False, False, False, False, False),
    "ddim": (False, True, False, False, False),
    "int8_bf16": (True, True, True, False, False),
    "pallas_int8": (True, True, False, True, False),
    "pallas_v2": (True, True, False, True, True),
}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(n_train_steps: int = 1500, mc_trials: int = 100, seed: int = 0, verbose: bool = True,
        device="cuda") -> dict:
    """Train one member for ``n_train_steps`` at batch 128, then sample the
    41-point grid with ``mc_trials`` trials in each row of ``ROWS``.
    Returns ``{"train": {"seconds", "loss"}, row: {"mae", "seconds",
    "launches"}}``; ``launches`` counts each kernel's launches in the row
    (none on the CPU, where the kernels' plain versions run)."""
    dev = resolve_device(device)
    gmm = GaussianMixture1D(mu=(-1.0, 1.0), sigma=(0.6, 0.6), seed=seed)
    sched = DiffusionSchedule.create("linear", T, 1e-4, 0.02, device=dev)
    geometry = dict(data_dim=1, feature_dim=64, hidden_dim=64, y_dim=2, n_steps=T + 1)
    compute = ConditionalModel(1, **geometry, device="meta", dtype=torch.float32)
    tx = make_optimizer("Adam", 1e-3)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = create_member_state(compute, gen, tx, device=dev)
    step = make_member_step(compute, tx, sched)

    flat = torch.full((BATCH, 2), 0.5, device=dev)
    eye = torch.eye(2, device=dev)
    t0 = time.perf_counter()
    for i in range(n_train_steps):
        x, y = gmm.sample(BATCH)
        state, loss = step(state, torch.from_numpy(x).to(dev), eye[torch.from_numpy(y).to(dev)], flat, gen)
        if verbose and i % 300 == 0:
            print(f"step {i}: loss {float(loss):.4f}")
    _sync(dev)
    out = {"train": {"seconds": time.perf_counter() - t0, "loss": float(loss)}}

    grid = np.linspace(-2.5, 2.5, 41, dtype=np.float32)[:, None]
    p_true = gmm.posterior(grid)
    x_grid = torch.from_numpy(grid).to(dev)
    flat_grid = torch.full((1, 41, 2), 0.5, device=dev)
    tau = ddim_timesteps(T, max(T // 20, 4))
    models = {dtype: conditional_model_from_state(state, use_ema=False, dtype=dtype, device=dev)
              for dtype in (torch.float32, torch.bfloat16)}
    for name, (bf16, ddim, int8, pallas, fuse) in ROWS.items():
        before = dict(launch_counts)
        _sync(dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            samples = nested_ensemble_sample(
                models[torch.bfloat16 if bf16 else torch.float32], x_grid, flat_grid, sched, mc_trials,
                tau=tau if ddim else None, generator=torch.Generator(device=dev).manual_seed(123),
                use_int8_eps=int8, use_int8_pallas=pallas, pallas_fuse_ends=fuse,
            )[0]  # (mc_trials, 41, 2)
            p_hat = samples.argmax(-1).float().mean(0).cpu().numpy()
        out[name] = {
            "mae": float(np.abs(p_hat - p_true).mean()),
            "seconds": time.perf_counter() - t0,
            "launches": {k: v - before.get(k, 0) for k, v in launch_counts.items() if v != before.get(k, 0)},
        }
        if verbose and name == "ancestral":
            for i in range(0, 41, 8):
                print(f"x={grid[i, 0]:+.2f}  p_true={p_true[i]:.3f}  p_mc={p_hat[i]:.3f}")
    if verbose:
        print("MAE(p_mc, p_analytic): " + "  ".join(f"{n}={out[n]['mae']:.4f}" for n in ROWS))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--steps", type=int, default=1500)
    parser.add_argument("--trials", type=int, default=100)
    args = parser.parse_args(argv)
    out = run(args.steps, args.trials, device=args.device)
    return 0 if all(out[n]["mae"] < 0.1 for n in ROWS) else 1


if __name__ == "__main__":
    sys.exit(main())
