"""Real-data run of the port: the three-stage LaDiNE pipeline and its
evaluation on scikit-learn's handwritten digits (10 classes).

The port's counterpart of ``scripts/run_digits.py``, with its stages, flags,
seeds and epochs, at ``configs/digits.yml``'s widths (32 px, patch 8, embed
48, depth 5, 4 heads, feature = hidden = 64, T = 100, 5 members, MC 10):

1. the ViT (``cli.train_transformer``, 40 epochs at batch 32);
2. five mapping MLPs (``cli.train_mapping --mlp_idx k --save_dtype
   float32``);
3. five members (``cli.main --train --seed 2000+k --precompute_guidance
   --light_ckpt``, 40 epochs);
4. ``--calib``, then ``--test`` at DDIM-25 eta 1 with the fitted
   temperature; the debiased-EMA arm with its own temperature; FGSM 0.03 on
   the ViT; Gaussian noise 0.1.

Each step runs in this process through the port's ``main(argv)``, its
output appended to a log in ``--work``; a step whose artifact is complete
is skipped, so a cut run resumes. The corpus is the committed IDX tree
(``examples/data/digits``, written by ``make_digits_corpus``), copied into
``--work``. Writes ``digits_summary.json`` into ``--work`` with the wall
seconds of each stage, and with ``--evidence DIR`` also
``DIR/torch_digits_summary.json`` and ``DIR/RESULTS_digits_torch.md`` (the
JAX run's rows beside, where ``DIR/digits_summary.json`` holds them).

    python -m ladine_tpu_torch.examples.run_digits --work _digits_run [--device cpu] [--fast]
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import glob
import importlib
import json
import os
import re
import shutil
import sys
import time
from typing import Callable, Optional

import torch

from ladine_tpu_torch.device import card_line, resolve_device
from ladine_tpu_torch.examples.make_digits_corpus import CORPUS

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "configs", "digits.yml")
DIMS = ["--image_size", "32", "--patch_size", "8", "--embed_dim", "48", "--depth", "5", "--num_heads", "4"]
MLP_DIMS = ["--mlp_hidden_dims", "64", "32", "16"]
CLI = "ladine_tpu_torch.cli."
REPORT_KEYS = ("majority_vote_accuracy", "majority_vote_accuracy_ci95_pp", "mean_confidence_accuracy",
               "mean_confidence_accuracy_ci95_pp", "ece", "nll", "brier", "num_instances")


def last_json(log_path: str) -> Optional[dict]:
    """The last line of ``log_path`` that is a JSON object: a CLI's summary."""
    out = None
    with open(log_path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{") and line.endswith("}"):
                try:
                    out = json.loads(line)
                except json.JSONDecodeError:
                    pass
    return out


def run_step(module: str, argv: list, log_path: str, done: Optional[Callable[[], bool]] = None) -> float:
    """``module.main(argv)`` in this process, its standard output appended
    to ``log_path``; raises unless it returns 0 and ``done()`` then holds.
    Returns its wall seconds."""
    main = importlib.import_module(module).main
    print(f"[run] {module} {' '.join(argv)}", file=sys.stderr)
    t0 = time.perf_counter()
    with open(log_path, "a") as f:
        f.write(f"\n===== {module} {' '.join(argv)}\n")
        f.flush()
        with contextlib.redirect_stdout(f):
            rc = main(argv)
    seconds = time.perf_counter() - t0
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    if rc != 0 or (done is not None and not done()):
        with open(log_path) as f:
            tail = f.read()[-3000:]
        raise RuntimeError(f"step {module} failed (rc={rc}, artifact complete: {done is None or done()}):\n{tail}")
    held = f", {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated" if torch.cuda.is_available() else ""
    print(f"[run] rc=0 ({seconds:.1f} s{held})", file=sys.stderr)
    return seconds


def copy_corpus(root: str) -> None:
    """The committed gzipped IDX tree into ``{root}/MNIST/raw``."""
    raw = os.path.join(root, "MNIST", "raw")
    os.makedirs(raw, exist_ok=True)
    for path in glob.glob(os.path.join(CORPUS, "MNIST", "raw", "*.gz")):
        shutil.copy(path, raw)


def run(work: str, device="cuda", fast: bool = False, epochs: Optional[tuple] = None,
        step: Callable = run_step) -> dict:
    """The pipeline into ``work``; returns the summary. ``epochs``: (stage 1,
    stage 3) epochs, (40, 40) by default and (2, 2) with ``fast``. ``step``
    runs one step as :func:`run_step` does."""
    dev = resolve_device(device)
    os.makedirs(work, exist_ok=True)
    on = ["--device", dev.type]
    root, models, exp = (os.path.join(work, d) for d in ("digits_root", "models", "exp"))
    log = os.path.join(work, "driver.log")
    e1, e3 = epochs or ((2, 2) if fast else (40, 40))
    seconds = {}

    def timed(stage, *a, **k):
        seconds[stage] = seconds.get(stage, 0.0) + step(*a, **k)

    if not os.path.exists(os.path.join(root, "MNIST", "raw", "train-images-idx3-ubyte.gz")):
        copy_corpus(root)

    # ---- stage 1a: the ViT ----------------------------------------------------
    s1a_log = os.path.join(work, "stage1a.log")
    vit_ckpt = os.path.join(models, "vit_MNIST")
    vit_done = lambda: os.path.exists(os.path.join(vit_ckpt, "ladine_meta.json"))  # noqa: E731
    if not vit_done():
        timed("stage1a_vit", CLI + "train_transformer",
              [*on, *DIMS, "--dataset", "MNIST", "--dataroot", root, "--num_classes", "10", "--epochs", str(e1),
               "--batch_size", "32", "--out", models], s1a_log, vit_done)
    s1a = last_json(s1a_log) if os.path.exists(s1a_log) else None

    # ---- stage 1b: the mapping MLPs ---------------------------------------------
    s1b_log = os.path.join(work, "stage1b.log")
    mlp_dir = os.path.join(models, "MNIST", "MLPs")

    def mlp_meta(k):
        return os.path.join(mlp_dir, f"block_{k}", "ladine_meta.json")

    for k in range(5):
        if not os.path.exists(mlp_meta(k)):
            timed("stage1b_mlps", CLI + "train_mapping",
                  [*on, *DIMS, *MLP_DIMS, "--dataset", "MNIST", "--dataroot", root, "--num_classes", "10",
                   "--epochs", str(e1), "--batch_size", "32", "--out", models, "--vit_ckpt", vit_ckpt,
                   "--num_members", "5", "--mlp_idx", str(k), "--save_dtype", "float32"],
                  s1b_log, lambda k=k: os.path.exists(mlp_meta(k)))
    s1b_accs = []
    for k in range(5):
        if os.path.exists(mlp_meta(k)):
            with open(mlp_meta(k)) as f:
                s1b_accs.append(round(json.load(f).get("accuracy", -1), 2))
        else:
            s1b_accs.append("?")

    # ---- stage 3: the members ---------------------------------------------------
    def best_ckpt(doc):
        found = [p for p in glob.glob(os.path.join(exp, "logs", doc, "diffu*_ckpt_best_*"))
                 if not p.endswith("_aux") and os.path.exists(os.path.join(p, "ladine_meta.json"))]
        return max(found, default=None, key=lambda p: int(re.search(r"_eph(\d+)_", p).group(1)))

    member_ckpts = []
    for k in range(5):
        doc = f"member{k}"
        ck = best_ckpt(doc)
        if ck is None:
            marker = os.path.join(exp, "logs", doc, "train_complete.json")
            timed("stage3_members", CLI + "main",
                  [*on, "--train", "--config", CONFIG, "--dataroot", root, "--exp", exp, "--doc", doc,
                   "--seed", str(2000 + k), "--mlp_idx", str(k), "--n_epochs", str(e3), "--precompute_guidance",
                   "--light_ckpt", "--vit_ckpt", vit_ckpt, "--mlp_ckpt_dir", mlp_dir],
                  log, lambda doc=doc, m=marker: os.path.exists(m) and best_ckpt(doc) is not None)
            ck = best_ckpt(doc)
        member_ckpts.append(ck)

    common = ["--config", CONFIG, "--dataroot", root, "--exp", exp, "--diffusion_ckpt", *member_ckpts]

    def eval_step(doc, extra):
        rpt = os.path.join(exp, "logs", doc, "report.json")
        if not os.path.exists(rpt):
            timed(doc, CLI + "main", [*on, *extra, *common, "--doc", doc], log, lambda: os.path.exists(rpt))
        with open(rpt) as f:
            return json.load(f)

    sampler = ["--ddim", "25", "--eta", "1.0"]
    calib = eval_step("calib", ["--calib", *sampler])
    temp = calib["calibrated_temperature"]
    clean = eval_step("test", ["--test", *sampler, "--temperature", str(temp)])
    # the debiased EMA weights, calibrated with their own temperature
    ema_calib = eval_step("calib_ema", ["--calib", *sampler, "--eval_ema"])
    ema = eval_step("test_ema", ["--test", *sampler, "--eval_ema", "--temperature",
                                 str(ema_calib["calibrated_temperature"])])
    # robustness: white-box FGSM on the ViT, and Gaussian noise
    atk = eval_step("test_fgsm", ["--test", *sampler, "--attack_name", "FGSM", "--epsilon", "0.03",
                                  "--temperature", str(temp)])
    noise = eval_step("test_noise", ["--test", *sampler, "--noise_perturbation", "0.1", "--temperature", str(temp)])

    def pick(r):
        return {k: r.get(k) for k in REPORT_KEYS}

    out = {
        "dataset": "sklearn digits (real scanned digits, 10 classes)",
        "device": card_line(dev),
        "torch": torch.__version__,
        "epochs": {"stage1": e1, "stage3": e3},
        "stage1a_vit_val_acc": (s1a or {}).get("best_val_accuracy"),
        "stage1b_mlp_val_accs": s1b_accs,
        "calibrated_temperature": temp,
        "calibrated_temperature_ema": ema_calib["calibrated_temperature"],
        "ece_vote_fraction_limit": calib.get("ece_vote_fraction_limit"),
        "test": pick(clean),
        "test_ema_debiased": pick(ema),
        "test_fgsm_eps0.03": pick(atk),
        "test_noise_0.1": pick(noise),
        "stage_seconds": seconds,
    }
    with open(os.path.join(work, "digits_summary.json"), "w") as f:
        json.dump(out, f, indent=2)
    with open(os.path.join(work, "RESULTS_digits_torch.md"), "w") as f:
        f.write(results_md(out))
    return out


ROWS = (("clean test (355 instances)", "test"),
        ("clean test, debiased EMA weights (--eval_ema, own T)", "test_ema_debiased"),
        ("attack: FGSM eps 0.03 (white-box ViT)", "test_fgsm_eps0.03"),
        ("corruption: gaussian noise 0.1", "test_noise_0.1"))


def results_md(out: dict, reference: Optional[dict] = None) -> str:
    """The summary as a markdown table; ``reference`` (the JAX run's
    summary) adds its mv-acc and ECE beside each row."""
    def row(name, key):
        r = out[key]
        cells = [name, f"{r['mean_confidence_accuracy']:.2f} ± {r['mean_confidence_accuracy_ci95_pp']:.1f}",
                 f"{r['majority_vote_accuracy']:.2f} ± {r['majority_vote_accuracy_ci95_pp']:.1f}",
                 f"{r['ece']:.4f}", f"{r['nll']:.4f}", f"{r['brier']:.4f}"]
        if reference is not None:
            ref = reference[key]
            cells += [f"{ref['majority_vote_accuracy']:.2f} ± {ref['majority_vote_accuracy_ci95_pp']:.1f}",
                      f"{ref['ece']:.4f}"]
        return "| " + " | ".join(cells) + " |"

    head = "| evaluation | acc % | mv-acc % | ECE | NLL | Brier |"
    rule = "|---|---|---|---|---|---|"
    if reference is not None:
        head, rule = head + " JAX mv-acc % | JAX ECE |", rule + "---|---|"
    e = out["epochs"]
    lines = [
        "# RESULTS — real data (sklearn handwritten digits), the PyTorch port",
        "",
        "The three-stage pipeline of `ladine_tpu_torch` on scikit-learn's bundled",
        "scanned digits (1,797 8x8 images, 10 classes; 1,442 train, 355 test),",
        "read from the committed IDX tree `ladine_tpu_torch/examples/data/digits`,",
        "at `configs/digits.yml`'s widths (32 px, 5-block ViT, 5 members, T = 100);",
        f"{e['stage1']} epochs in stage 1, {e['stage3']} in stage 3; evaluation DDIM-25",
        "eta 1, MC 10. Reproduce: `python -m ladine_tpu_torch.examples.run_digits",
        "--work <dir> --evidence evidence`.",
        "",
        f"- device: {out['device']}; torch {out['torch']}",
        f"- stage-1a ViT val acc: **{out['stage1a_vit_val_acc']:.2f}%**; stage-1b mapping-MLP val accs: "
        f"{out['stage1b_mlp_val_accs']}",
        f"- calibrated temperature: {out['calibrated_temperature']:.4g} (vote-fraction ECE limit "
        f"{out['ece_vote_fraction_limit']:.4f}); the EMA weights' own: {out['calibrated_temperature_ema']:.4g}",
        "",
        head,
        rule,
        *(row(name, key) for name, key in ROWS),
        "",
        "Wall seconds by stage: " + ", ".join(f"{k} {v:.1f}" for k, v in out["stage_seconds"].items()) + ".",
    ]
    if reference is not None:
        lines += ["", "JAX columns: `evidence/digits_summary.json` (the JAX package's run on a CPU; its",
                  f"ViT val acc {reference['stage1a_vit_val_acc']:.2f}%). Fresh initialization draws from torch",
                  "generators, so the weights differ from the JAX run's."]
    return "\n".join(lines) + "\n"


def write_evidence(out: dict, evidence: str) -> None:
    """``torch_digits_summary.json`` and ``RESULTS_digits_torch.md`` into
    ``evidence``, never the JAX run's ``digits_summary.json``."""
    os.makedirs(evidence, exist_ok=True)
    ref_path = os.path.join(evidence, "digits_summary.json")
    reference = None
    if os.path.exists(ref_path):
        with open(ref_path) as f:
            reference = json.load(f)
    with open(os.path.join(evidence, "torch_digits_summary.json"), "w") as f:
        json.dump(out, f, indent=2)
    with open(os.path.join(evidence, "RESULTS_digits_torch.md"), "w") as f:
        f.write(results_md(out, reference))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", type=str, default="_digits_run")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--fast", action="store_true", help="2 epochs a stage: a wiring check, not evidence")
    ap.add_argument("--evidence", type=str, default=None,
                    help="also write torch_digits_summary.json and RESULTS_digits_torch.md here")
    args = ap.parse_args(argv)
    out = run(args.work, args.device, args.fast)
    if args.evidence:
        write_evidence(out, args.evidence)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
