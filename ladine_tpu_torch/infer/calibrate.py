"""Temperature calibration on cached MC samples.

Counterpart of ``ladine_tpu/infer/calibrate.py``. The temperature enters
only through ``convert_to_prob``, so the samples are drawn once and each
objective evaluation reweights them (the reference re-runs the whole
inference per evaluation; the optimum is the same).

* ``temperature_search``: Nelder-Mead on the ECE (the reference's settings:
  x0 = 0.2555, xatol 1e-4, fatol 1e-5), or a geomspace scan without scipy.
* ``tune_temperature_nll``: gradient descent on the NLL of a
  softplus-parameterized temperature (the reference's ``--tune_T`` path),
  with ``torch.autograd``.

Both run on the host, on float32 tensors, as the JAX package does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ladine_tpu_torch.metrics.classification import ece, ensemble_confidence, nll


def _tensors(samples, labels):
    return (torch.as_tensor(np.asarray(samples), dtype=torch.float32),
            torch.as_tensor(np.asarray(labels), dtype=torch.int64))


def calibration_objective(samples, labels, temperature: float) -> float:
    """ECE of the ensemble mean confidence at ``temperature``."""
    s, y = _tensors(samples, labels)
    return float(ece(ensemble_confidence(s, float(temperature)), y))


def temperature_search(
    samples,
    labels,
    x0: float = 0.2555,
    xatol: float = 1e-4,
    fatol: float = 1e-5,
    max_iter: int = 200,
) -> Tuple[float, float]:
    """Nelder-Mead over the cached-sample ECE. Returns (best temperature,
    its ECE). Without scipy, the best of 400 temperatures in
    geomspace(1e-3, 10)."""
    s, y = _tensors(samples, labels)

    def f(t):
        t = float(np.atleast_1d(t)[0])
        if t <= 0:
            return 1e9  # the temperature must be positive
        return float(ece(ensemble_confidence(s, t), y))

    try:
        from scipy.optimize import minimize
    except ImportError:
        ts = np.geomspace(1e-3, 10.0, 400)
        vals = [f(t) for t in ts]
        i = int(np.argmin(vals))
        return float(ts[i]), float(vals[i])
    res = minimize(f, x0=[x0], method="Nelder-Mead",
                   options={"xatol": xatol, "fatol": fatol, "maxiter": max_iter})
    return float(res.x[0]), float(res.fun)


def tune_temperature_nll(samples, labels, init: float = 0.2555, lr: float = 0.01,
                         steps: int = 500) -> float:
    """Gradient fit of T = softplus(raw) minimizing the NLL on cached
    samples, from softplus(raw) == ``init``."""
    s, y = _tensors(samples, labels)
    raw = float(np.log(np.expm1(init)))
    for _ in range(steps):
        r = torch.tensor(raw, dtype=torch.float32, requires_grad=True)
        loss = nll(ensemble_confidence(s, torch.nn.functional.softplus(r)), y, eps=1e-12)
        (g,) = torch.autograd.grad(loss, r)
        raw = raw - lr * float(g)
    return float(np.logaddexp(0.0, raw))  # softplus(raw)
