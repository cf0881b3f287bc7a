"""Whether a run's outputs are correct: the program's outputs against the
plain reference's, on a sample of the finished requests drawn from the
seed, on the same images and the same draws.

The judge reads, over the compared images:

* ``var_gap`` and ``piw_gap``: the median gap of the MC variance and of
  the 95 % interval width of the class the program voted for, each as a
  share of the reference's value there or of the median over the compared
  images where that is larger (some images' samples all but agree). The
  median, since the chains of a few images in a few seeds are far more
  sensitive than the rest (PERF.md);
* ``var_gap_max`` and ``piw_gap_max``: the largest of those gaps;
* ``probs_gap``: the largest gap of a class probability;
* ``vote_gap``: the largest share of the MC samples by which the reference
  prefers its own vote to the program's (0 where they agree).

The configuration's file holds a limit for each number it compares
(``limits``; how each was set, and why a number is left out, is in
PERF.md). The others are printed beside them. ``probs_gap`` and
``vote_gap`` catch gross faults of the probabilities and the vote, which
the variance and the interval width do not see; with random weights the
tempered probabilities saturate, so they separate no precision. An output
that is not finite reads as an infinite gap.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

NUMBERS = ("var_gap", "piw_gap", "var_gap_max", "piw_gap_max", "probs_gap", "vote_gap")


def sample_requests(run, traffic, seed: int) -> List[dict]:
    """Finished requests drawn from the seed until ``compare_rows`` rows."""
    done = run.completed
    rng = np.random.default_rng([int(seed), 11])
    picked, rows = [], 0
    for i in rng.permutation(len(done)):
        if rows >= traffic["compare_rows"]:
            break
        picked.append(done[i])
        rows += len(done[i]["ids"])
    return picked


def compared_rows(run, picked: List[dict], family, cfg, seed: int, device):
    """The pool rows and the draws of the picked requests, as one batch:
    a request's draws are those of the call that served it, at its rows
    in that call."""
    ids, draws = [], []
    for rec in picked:
        if run.calls is None:
            index, batch, rows = rec["index"], len(rec["ids"]), list(range(len(rec["ids"])))
        else:
            call = next(c for c in reversed(run.calls) if c["t1"] <= rec["done"] and rec["ids"][0] in c["ids"])
            index, batch = call["index"], call["rows"]
            rows = [call["ids"].index(i) for i in rec["ids"]]
        draws.append(family.noise(cfg, batch, seed, index, device)[:, :, :, rows])
        ids += rec["ids"]
    return ids, torch.cat(draws, dim=3)


def gaps(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The numbers over the rows of ``prog`` (a predictor's outputs) and
    ``ref`` (the reference's, per class)."""
    if not all(np.isfinite(prog[k]).all() for k in ("probs", "piw", "var")):
        return {n: float("inf") for n in NUMBERS}
    rows = np.arange(len(prog["vote"]))
    vote = prog["vote"].astype(np.int64)
    out = {}
    for key in ("var", "piw"):
        want = ref[key][rows, vote]
        scale = np.maximum(want, np.median(ref[key][rows, ref["vote"]]))
        gap = np.abs(prog[key] - want) / scale
        out[f"{key}_gap"], out[f"{key}_gap_max"] = float(np.median(gap)), float(gap.max())
    out["probs_gap"] = float(np.abs(prog["probs"] - ref["probs"]).max())
    counts = ref["counts"]
    out["vote_gap"] = float(((counts[rows, ref["vote"]] - counts[rows, vote]) / counts.sum(-1)).max())
    return out


def judge(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray], limits: Dict[str, float]):
    """({number: {"value", "limit"}} of the compared numbers, all within
    their limits, {number: value} of the others)."""
    g = gaps(prog, ref)
    checks = {n: dict(value=g[n], limit=float(limits[n])) for n in NUMBERS if n in limits}
    return checks, all(c["value"] <= c["limit"] for c in checks.values()), \
        {n: g[n] for n in NUMBERS if n not in limits}


def stack(outs: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def judge_run(run, picked, family, cfg, seed: int, device, pool):
    """The checks of a run's sample, whether they all pass (False where
    nothing finished), and the numbers not compared."""
    if not picked:
        return {n: dict(value=float("inf"), limit=float(v)) for n, v in cfg["limits"].items()}, False, {}
    ids, draws = compared_rows(run, picked, family, cfg, seed, device)
    ref = family.reference(cfg, seed, pool[ids], draws, device)
    return judge(stack([r["out"] for r in picked]), ref, cfg["limits"])
