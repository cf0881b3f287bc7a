"""Evaluation figures: a reliability diagram, per-class PIW bars, and a
qq-plot of the top-vs-runner-up MC differences (the t-test's normality
assumption), rendered from a ``compute_report`` dict into PNGs.

The port's own copy of ``ladine_tpu/utils/plots.py``. matplotlib (and
scipy, for the qq-plot) are imported only when a figure is drawn; without
matplotlib :func:`save_evaluation_plots` raises with a message (the CLI's
``--make_plots`` checks before it evaluates).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np


def require_matplotlib():
    """The matplotlib module, or a RuntimeError that says it is missing."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("--make_plots needs matplotlib, which this Python does not have; "
                           "install it or leave out --make_plots") from e
    return matplotlib


def save_evaluation_plots(report: Dict[str, Any], out_dir: str) -> list:
    """Render reliability / PIW / qq figures from a compute_report dict.
    Returns the written paths."""
    matplotlib = require_matplotlib()
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    written = []

    # reliability diagram
    rel = report.get("reliability")
    if rel:
        conf = np.asarray(rel["confidence"])
        acc = np.asarray(rel["accuracy"])
        count = np.asarray(rel["count"])
        centers = (np.arange(len(conf)) + 0.5) / len(conf)
        fig, ax = plt.subplots(figsize=(5, 5))
        mask = count > 0
        ax.bar(centers[mask], acc[mask], width=1 / len(conf) * 0.9, alpha=0.7,
               label="accuracy")
        ax.plot([0, 1], [0, 1], "k--", lw=1, label="perfect calibration")
        ax.plot(centers[mask], conf[mask], "r.", label="mean confidence")
        ax.set_xlabel("confidence bin")
        ax.set_ylabel("accuracy")
        ax.set_title(f"reliability (ECE={report.get('ece', float('nan')):.4f}, "
                     f"T={report.get('temperature', float('nan')):.4f})")
        ax.legend()
        p = os.path.join(out_dir, "reliability.png")
        fig.savefig(p, dpi=120, bbox_inches="tight")
        plt.close(fig)
        written.append(p)

    # per-class PIW bars (correct vs incorrect — the paper's uncertainty gap)
    if "piw_correct" in report:
        c = np.asarray(report["piw_correct"], dtype=float)
        i = np.asarray(report["piw_incorrect"], dtype=float)
        x = np.arange(len(c))
        fig, ax = plt.subplots(figsize=(5, 4))
        ax.bar(x - 0.2, np.nan_to_num(c), width=0.4, label="correct")
        ax.bar(x + 0.2, np.nan_to_num(i), width=0.4, label="incorrect")
        ax.set_xlabel("class")
        ax.set_ylabel("mean PIW (2.5-97.5%)")
        ax.set_title("prediction-interval width by correctness")
        ax.legend()
        p = os.path.join(out_dir, "piw_per_class.png")
        fig.savefig(p, dpi=120, bbox_inches="tight")
        plt.close(fig)
        written.append(p)

    # qq-plot of top-vs-runner-up MC differences (t-test normality check)
    samples = report.get("samples")
    if samples is not None:
        s = np.asarray(samples)  # (S, N, C)
        mean = s.mean(axis=0)
        order = np.argsort(-mean, axis=1)
        n = s.shape[1]
        d = s[:, np.arange(n), order[:, 0]] - s[:, np.arange(n), order[:, 1]]
        d = (d - d.mean(0)) / (d.std(0) + 1e-9)
        flat = np.sort(d.reshape(-1))
        from scipy import stats

        theo = stats.norm.ppf((np.arange(len(flat)) + 0.5) / len(flat))
        fig, ax = plt.subplots(figsize=(5, 5))
        step = max(1, len(flat) // 2000)
        ax.plot(theo[::step], flat[::step], ".", ms=2)
        ax.plot([-3, 3], [-3, 3], "k--", lw=1)
        ax.set_xlabel("theoretical normal quantiles")
        ax.set_ylabel("observed quantiles")
        ax.set_title("qq-plot: top-vs-runner-up MC differences")
        p = os.path.join(out_dir, "qq_mc_differences.png")
        fig.savefig(p, dpi=120, bbox_inches="tight")
        plt.close(fig)
        written.append(p)

    return written
