"""The crop row's chains image by image, on the weights of a ``run_results``
run: which test images' MC variance blows up, in bf16 and in float32, and
without the crop.

For every test batch of the run's suite (``configs/synthetic224.yml``: 70
images, ``drop_last``) the crop row's corrupted images and chain noise are
made exactly as its suite row made them (``EvalPipeline.prepare`` from a
generator of ``cli.main``'s default ``--seed``, checked against the crop's
own draws); the clean (``d50``) row takes the same noise, since each row's
generator gives every batch the same streams. Each arm is one
``Predictor.predict`` (DDIM-50, eta 1, the run's calibrated temperature)
with that noise injected:

  bf16_crop    the crop row as the suite ran it
  bf16_clean   the same images and noise without the crop
  fp32_crop    the crop row's images and noise, every weight and the chain in float32 (``cli.main --fp32``)
  fp32_clean   the same without the crop
  bf16_crop_interpolate  the crop resized by ``F.interpolate`` (the port's resize before it
               followed the JAX package's arithmetic), the same corners and noise

Each arm records, per image, the vote, the MC variance and the PIW at the
voted class (``predict``'s outputs) and, from the program's samples of the
same inputs (``EvalPipeline.sample``), each member's variance at that class
and the largest |sample|. The bf16 crop arm's per-class means are set beside
the suite's ``report_crop.json``. Writes ``--out`` (every image) and prints
the images whose variance exceeds 1 in any arm as the last line.

    python -m ladine_tpu_torch.examples.crop_chains --work _results_run [--out crop_chains.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ladine_tpu_torch.device import card_line, resolve_device
from ladine_tpu_torch.examples.run_results import MEMBERS, best_ckpt, suite_dict
from ladine_tpu_torch.ops.corruptions import apply_corruptions

CROP = "crop"
CLEAN = "d50"
THRESHOLD = 1.0  # an outlier: MC variance at the vote above it (the clean rows' largest is ~0.5)


def interpolate_crop(images: torch.Tensor, corners, k: float) -> torch.Tensor:
    """The crop at ``corners`` resized by ``F.interpolate`` (bilinear, half-pixel
    centers, no antialiasing): NHWC in and out."""
    b, h, w, c = images.shape
    size = int(w * (1.0 - k))
    out = [F.interpolate(images[i:i + 1, t:t + size, l:l + size].permute(0, 3, 1, 2), size=(h, w),
                         mode="bilinear", align_corners=False, antialias=False).permute(0, 2, 3, 1)
           for i, (t, l) in enumerate(zip(*(t.tolist() for t in corners)))]
    return torch.cat(out)


def _argv(work: str, device: str, fp32: bool) -> List[str]:
    """``cli.main``'s flags of the run's suite (``run_results``), with the
    calibrated temperature."""
    exp = os.path.join(work, "exp")
    with open(os.path.join(work, "results_summary.json")) as f:
        config = json.load(f)["config"]
    with open(os.path.join(exp, "logs", "calib", "report.json")) as f:
        temperature = json.load(f)["calibrated_temperature"]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ckpts = [best_ckpt(exp, f"member{k}") for k in range(MEMBERS)]
    return ["--device", device, "--test", "--temperature", str(temperature),
            "--config", os.path.join(repo, config), "--dataroot", os.path.join(work, "synth_ds"), "--exp", exp,
            "--diffusion_ckpt", *ckpts, "--doc", "crop_chains", *(["--fp32"] if fp32 else [])]


def _setup(work: str, device: str, fp32: bool):
    """(runner, guidance, members, {row: EvalConfig}, seed) as ``cli.main
    --test`` builds them for the run's suite."""
    from ladine_tpu_torch.cli.main import build_config, build_parser, eval_config, train_ckpt_weights
    from ladine_tpu_torch.cli.runner import Runner

    args = build_parser().parse_args(_argv(work, device, fp32))
    cfg = build_config(args)
    runner = Runner(cfg, log_dir=os.path.join(work, "exp", "logs", args.doc), device=device)
    runner.temperature = args.temperature
    base = eval_config(args, cfg, args.temperature)
    stacked, gvars, base = train_ckpt_weights(runner, args, args.diffusion_ckpt, base)
    rows = {name: dataclasses.replace(base, **suite_dict(False)[name]) for name in (CROP, CLEAN)}
    return runner, runner.guidance_module(gvars), runner.members_module(stacked), rows, args.seed


def _run_arm(predictor, pipeline, batches) -> Dict[str, list]:
    """Per image: ``predict``'s vote, MC variance and PIW, each member's
    variance at the vote and the largest |sample| (the pipeline's samples
    of the same images and noise)."""
    out = {"pred": [], "var": [], "piw": [], "member_var": [], "max_abs": [], "var_from_samples": []}
    for x, z in batches:
        got = predictor.predict(x, noise=z)
        samples = pipeline.sample(x.to(pipeline.device), z.to(pipeline.device))  # (M, K, B, C)
        vote = torch.as_tensor(got["majority_vote"]).long()
        m, k, b, c = samples.shape
        at_vote = samples.gather(3, vote.view(1, 1, b, 1).expand(m, k, b, 1))[..., 0]  # (M, K, B)
        out["pred"] += vote.tolist()
        out["var"] += got["mc_variance"].astype(float).tolist()
        out["piw"] += got["piw"].astype(float).tolist()
        out["member_var"] += at_vote.var(dim=1, correction=1).T.tolist()
        out["max_abs"] += samples.abs().amax(dim=(0, 1, 3)).tolist()
        out["var_from_samples"] += at_vote.reshape(m * k, b).var(dim=0, correction=1).tolist()
    return out


def _class_means(arm: Dict[str, list], labels: np.ndarray, classes: int) -> Dict[str, list]:
    """The report's ``mc_variance_correct``/``_incorrect``: per voted class,
    the mean variance of correct and of incorrect votes (0 where none)."""
    pred, var = np.asarray(arm["pred"]), np.asarray(arm["var"])
    res = {"mc_variance_correct": [], "mc_variance_incorrect": []}
    for cls in range(classes):
        for key, mask in (("mc_variance_correct", (pred == cls) & (labels == cls)),
                          ("mc_variance_incorrect", (pred == cls) & (labels != cls))):
            res[key].append(float(var[mask].mean()) if mask.any() else 0.0)
    return res


def _collect() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(work: str, device="cuda") -> dict:
    """Every arm over the run's test split; returns the record (module docstring)."""
    from ladine_tpu_torch.infer import Predictor
    from ladine_tpu_torch.infer.evaluator import _streams, make_eval_pipeline

    dev = resolve_device(device)
    runner, guidance, model, rows, seed = _setup(work, dev.type, fp32=False)
    c = runner.config.testing
    crop_k = rows[CROP].crop
    pipes = {name: make_eval_pipeline(guidance, model, runner.sched, cfg, device=dev) for name, cfg in rows.items()}
    gens = {name: torch.Generator().manual_seed(seed) for name in rows}
    inputs = {"crop": [], "clean": [], "crop_interpolate": []}
    labels, index = [], []
    for images, y, idx in runner.batches("test", c.batch_size, drop_last=c.drop_last, with_indices=True):
        state = gens[CROP].get_state()
        x_crop, z = pipes[CROP].prepare(images, y, gens[CROP])
        x_clean, z_clean = pipes[CLEAN].prepare(images, y, gens[CLEAN])
        if not torch.equal(z, z_clean):
            raise RuntimeError("the crop and clean rows drew different chain noise")
        # the crop row's corners, drawn again from its stream as random_crop_and_resize draws them
        again = torch.Generator()
        again.set_state(state)
        g_corrupt = _streams(again, dev)[0]
        b, h, w, _ = x_crop.shape
        size = int(w * (1.0 - crop_k))
        corners = (torch.randint(0, h - size + 1, (b,), generator=g_corrupt, device=dev),
                   torch.randint(0, w - size + 1, (b,), generator=g_corrupt, device=dev))
        raw = torch.as_tensor(np.asarray(images), dtype=torch.float32).to(dev)
        if not torch.equal(apply_corruptions(raw, crop=crop_k, draws={"crop": corners}), x_crop):
            raise RuntimeError("the crop's corners are not the crop row's")
        inputs["crop"].append((x_crop.cpu(), z.cpu()))
        inputs["clean"].append((x_clean.cpu(), z.cpu()))
        inputs["crop_interpolate"].append((interpolate_crop(raw, corners, crop_k).cpu(), z.cpu()))
        labels += np.asarray(y).tolist()
        index += np.asarray(idx).tolist()
    labels_np = np.asarray(labels)

    arms = {}
    for dtype in ("bf16", "fp32"):
        if dtype == "fp32":
            del pipes, guidance, model
            _collect()
            runner, guidance, model, rows, _ = _setup(work, dev.type, fp32=True)
        cfg = rows[CLEAN]
        predictor = Predictor(guidance=guidance, model=model, sched=runner.sched, temperature=cfg.temperature,
                              mc_trials=cfg.mc_trials, ddim_steps=cfg.ddim_steps, ddim_eta=cfg.ddim_eta,
                              skip_type=cfg.skip_type, noise_prior=cfg.noise_prior, head_indices=cfg.head_indices,
                              device=dev)
        pipeline = make_eval_pipeline(guidance, model, runner.sched, cfg, device=dev)
        for name in ("crop", "clean") + (("crop_interpolate",) if dtype == "bf16" else ()):
            arms[f"{dtype}_{name}"] = _run_arm(predictor, pipeline, inputs[name])
        del predictor, pipeline
        _collect()

    classes = runner.config.data.num_classes
    report_path = os.path.join(work, "exp", "logs", "suite", "report_crop.json")
    suite_row = None
    if os.path.exists(report_path):
        with open(report_path) as f:
            rep = json.load(f)
        suite_row = {k: rep[k] for k in ("majority_vote_accuracy", "mc_variance_correct", "mc_variance_incorrect")}
    outliers = []
    for i in range(len(labels)):
        if any(arm["var"][i] > THRESHOLD for arm in arms.values()):
            outliers.append({"image": index[i], "label": labels[i],
                             **{name: {"pred": arm["pred"][i], "var": arm["var"][i], "piw": arm["piw"][i],
                                       "member_var": arm["member_var"][i], "max_abs": arm["max_abs"][i]}
                                for name, arm in arms.items()}})
    return {
        "device": card_line(dev),
        "seed": seed,
        "temperature": rows[CLEAN].temperature,
        "images": len(labels),
        "threshold": THRESHOLD,
        "labels": labels,
        "index": index,
        "arms": arms,
        "summary": {name: {"over_threshold": int(sum(v > THRESHOLD for v in arm["var"])),
                           "max_var": float(np.nanmax(arm["var"])),
                           "mv_accuracy": float((np.asarray(arm["pred"]) == labels_np).mean() * 100.0),
                           "predict_vs_samples_max_diff": float(np.nanmax(np.abs(
                               np.asarray(arm["var"]) - np.asarray(arm["var_from_samples"])))),
                           **_class_means(arm, labels_np, classes)}
                    for name, arm in arms.items()},
        "suite_report_crop": suite_row,
        "outliers": outliers,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", type=str, required=True, help="a finished run_results work directory")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", type=str, default=None, help="the whole record (default WORK/crop_chains.json)")
    args = ap.parse_args(argv)
    record = run(args.work, args.device)
    out = args.out or os.path.join(args.work, "crop_chains.json")
    with open(out, "w") as f:
        json.dump(record, f)
    brief = {k: record[k] for k in ("device", "images", "threshold", "summary", "suite_report_crop")}
    brief["outliers"] = [{k: o[k] for k in ("image", "label")} | {n: round(o[n]["var"], 4) for n in record["arms"]}
                         for o in record["outliers"]]
    print(json.dumps(brief))
    return 0


if __name__ == "__main__":
    sys.exit(main())
