"""Full-pipeline evidence run of the port at the paper's dimensions ->
``RESULTS_torch.md``.

The port's counterpart of ``scripts/run_results.py``, with its stages,
flags, seeds, epochs and batch sizes: ViT-B/16, five 150528 -> 4096 ->
2048 -> 128 mapping MLPs, five 150528 -> 4096 members, T = 1000, MC 20, on
the synthetic 2-class 224x224 corpus (``make_synth_medical``):

1. the corpus (250 training images a class, 75 validation, 600 test);
2. stage 1a, the ViT (``cli.train_transformer``, 80 epochs, batch 30);
3. stage 1b, five mapping MLPs, one a run (``cli.train_mapping --mlp_idx k
   --save_dtype bfloat16``);
4. the guidance's majority-vote accuracy (``cli.main --eval_guidance``);
5. stage 3, five members, one a run (``cli.main --train --seed 1000+k
   --mlp_idx k --precompute_guidance --light_ckpt``, 100 epochs;
   ``LADINE_SUITE_E3`` overrides);
6. ``--calib`` at DDIM-50 eta 1, then the whole ``--suite`` in one run
   (:func:`suite_dict`) at the fitted temperature, the suite getting only
   the rows whose report is missing; the fp32 cover A/B (``--fp32``); the
   debiased-EMA arm with its own temperature.

Each step runs in this process through the port's CLIs' ``main(argv)``
(``--device``, cuda by default), its output appended to a log in
``--work``, memory collected and the card's cache emptied after it. A step
whose artifact is complete is skipped (the corpus's ``corpus.json``, a
checkpoint's ``ladine_meta.json``, ``train_complete.json`` beside a best
checkpoint, a report), so a cut run resumes. A failed step raises.

``--fast`` (2 + 4 epochs, 60 training images a class, the six-row suite)
and ``--tiny`` (``configs/synthetic_tiny.yml``'s widths, implies
``--fast``) check the wiring. At the full widths ``--fast`` evaluates no
image: its 36 validation and 36 test images fill no batch of 70 under
``drop_last``, so :func:`run` refuses it before training (ROADMAP F8, a
fault of the JAX script kept here as its defaults are). ``--real`` runs a
reference ``.pth`` tree instead (:func:`run_real`).

Writes ``RESULTS_torch.md``, ``results_summary.json`` (the stages'
accuracies, epochs, device and seconds) and ``stage_seconds.json`` into
``--work``. With ``--evidence DIR`` (an evidence directory: the JAX run's
``report_*.json`` in ``DIR``, the port's in ``DIR/torch``) it then copies
its reports into ``DIR/torch`` (``sync_evidence``) and renders
``DIR/RESULTS_torch.md`` from them with the JAX rows beside
(``render_results``). It never writes the JAX run's ``RESULTS.md``.

    python -m ladine_tpu_torch.examples.run_results --work _results_run [--device cpu] [--fast] [--tiny]
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import re
import sys
import time
from typing import Callable, Dict, Optional

import torch

from ladine_tpu_torch.device import card_line, resolve_device
from ladine_tpu_torch.examples import make_synth_medical as synth
from ladine_tpu_torch.examples import sync_evidence
from ladine_tpu_torch.examples.run_digits import last_json, run_step

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CLI = "ladine_tpu_torch.cli."
MEMBERS = 5
TINY_DIMS = ["--image_size", "32", "--patch_size", "8", "--embed_dim", "32", "--depth", "5", "--num_heads", "2"]
TINY_MLP_DIMS = ["--mlp_hidden_dims", "32", "16", "8"]
CORRUPTION_ROWS = ("noise", "noise_hard", "contrast", "lowres", "cover", "crop")


def suite_dict(fast: bool) -> dict:
    """The named evaluation battery (EvalConfig overrides a row), in the
    order it runs: each int8 row right after its float comparandum, the
    1000-step ``full`` row after them, then the step sweep, the six
    corruptions in the reference's order and the two attacks."""
    d50 = {"ddim_steps": 50, "ddim_eta": 1.0}
    suite = {
        "d50": d50,  # the serving sampler
        "int8": {**d50, "use_int8": True},
        "d10": {"ddim_steps": 10, "ddim_eta": 1.0},
        # the fast preset: DDIM-10, int8 eps, resident int8 encoder and heads
        "int8_enc": {"ddim_steps": 10, "ddim_eta": 1.0, "use_int8": True, "use_int8_encode": True},
        # the K4 scan body on the same preset
        "int8_pallas": {"ddim_steps": 10, "ddim_eta": 1.0, "use_int8_pallas": True, "use_int8_encode": True},
        # the K5 scan body (lin1 in lin2's pass, lin4 in lin3's epilogue)
        "int8_pallas_v2": {"ddim_steps": 10, "ddim_eta": 1.0, "use_int8_pallas": True, "pallas_fuse_ends": True,
                           "use_int8_encode": True},
        "full": {},  # the parity workload: the 1000-step ancestral chain
        "d25": {"ddim_steps": 25, "ddim_eta": 1.0},
        "noise": {**d50, "noise_std": 0.1},
        "noise_hard": {**d50, "noise_std": 0.2},
        "contrast": {**d50, "contrast": 0.6},
        "lowres": {**d50, "low_resolution": 2},
        "cover": {**d50, "cover": [0.05, 4]},
        "crop": {**d50, "crop": 0.1},
        "atk_fgsm": {**d50, "attack_name": "FGSM", "attack_eps": 0.03},
        "atk_pgd": {**d50, "attack_name": "PGD", "attack_eps": 0.03},
    }
    if fast:
        suite = {k: suite[k] for k in ("full", "d50", "d10", "noise", "atk_fgsm", "int8_enc")}
    return suite


def _ema_mode(ckpt_path) -> str:
    """'debiased' for a checkpoint of zero-initialized EMA accumulators,
    'legacy copy-init shadow' otherwise: which semantics an EMA row
    measured."""
    try:
        with open(os.path.join(ckpt_path, "ladine_meta.json")) as f:
            meta = json.load(f)
        return "debiased" if meta.get("ema_init") == "zero" else "legacy copy-init shadow"
    except (OSError, ValueError):
        return "unknown ema mode"


def md_row(name, r) -> str:
    """A table row of a report (an em dash a cell where it is missing),
    with the 95 % binomial half-widths where the report has them."""
    if r is None:
        return f"| {name} | — | — | — | — | — |"
    ci = r.get("mean_confidence_accuracy_ci95_pp")
    ci_mv = r.get("majority_vote_accuracy_ci95_pp")
    acc = f"{r['mean_confidence_accuracy']:.2f}" + (f" ± {ci:.1f}" if ci is not None else "")
    mv = f"{r['majority_vote_accuracy']:.2f}" + (f" ± {ci_mv:.1f}" if ci_mv is not None else "")
    return f"| {name} | {acc} | {mv} | {r['ece']:.4f} | {r['nll']:.4f} | {r['brier']:.4f}  |"


def uncertainty_lines(rows) -> list:
    """The PIW and MC-variance separation table at the predicted class
    (mean over classes), correct against incorrect predictions; ``rows`` is
    ``{label: report}``, an empty group a dash."""

    def mean_of(r, key):
        vals = [v for v in (r.get(key) or []) if v is not None and math.isfinite(v)]
        return f"{sum(vals) / len(vals):.3f}" if vals else "—"

    out = [
        "",
        "Uncertainty separation at the predicted class (mean over classes;",
        "the method's headline signal — incorrect predictions should carry",
        "wider prediction intervals and higher MC variance):",
        "",
        "| evaluation | PIW correct | PIW incorrect | MC var correct | MC var incorrect |",
        "|---|---|---|---|---|",
    ]
    for name, r in rows.items():
        if r is None:
            continue
        out.append(f"| {name} | {mean_of(r, 'piw_correct')} | {mean_of(r, 'piw_incorrect')} | "
                   f"{mean_of(r, 'mc_variance_correct')} | {mean_of(r, 'mc_variance_incorrect')} |")
    return out


def _read_json(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def work_reports(work: str) -> Dict[str, dict]:
    """The reports of a run in ``work`` under their evidence names
    (``calib``, ``calib_ema``, ``ema`` and the suite's rows)."""
    return {name[len("report_"):-len(".json")]: _read_json(src) for src, name in sync_evidence.pairs(work)
            if name.startswith("report_") and os.path.exists(src)}


def _add_seconds(work: str, stage: str, seconds: float) -> None:
    """Add a stage's wall seconds to ``stage_seconds.json``, so a resumed
    run keeps the seconds of the stages it skips."""
    path = os.path.join(work, "stage_seconds.json")
    table = _read_json(path) or {}
    table[stage] = table.get(stage, 0.0) + seconds
    with open(path, "w") as f:
        json.dump(table, f, indent=1)


def best_ckpt(exp: str, doc: str) -> Optional[str]:
    """The newest complete best checkpoint of a member run (by epoch
    number; ``ladine_meta.json`` is written last)."""
    found = [p for p in glob.glob(os.path.join(exp, "logs", doc, "diffu*_ckpt_best_*"))
             if not p.endswith("_aux") and os.path.exists(os.path.join(p, "ladine_meta.json"))]
    return max(found, default=None, key=lambda p: int(re.search(r"_eph(\d+)_", p).group(1)))


def _evaluable(counts: Dict[str, int], config: str) -> None:
    """Refuse a corpus whose validation or test split fills no evaluation
    batch (F8): ``--calib`` and the suite would find no image to evaluate."""
    from ladine_tpu_torch.config import Config

    testing = Config.from_yaml(config).testing
    for split in ("validation", "testing"):
        n = 2 * counts[split]
        if testing.drop_last and n < testing.batch_size:
            raise ValueError(f"{n} {split} images fill no evaluation batch of {testing.batch_size} (drop_last): "
                             "the calibration and the suite would evaluate no image (ROADMAP F8; --fast at the full "
                             "widths); give run() a larger corpus")


def run(work: str, device="cuda", fast: bool = False, tiny: bool = False, evidence: Optional[str] = None,
        corpus: Optional[Dict[str, int]] = None, epochs: Optional[tuple] = None, seed: int = 0,
        step: Callable = run_step) -> dict:
    """The pipeline into ``work``; returns ``{"reports": ..., "steps": n,
    ...}``. ``corpus``: images a class of each split (default the script's:
    ``--n 250 --test_n 600``, or ``--n 60`` with ``fast``); ``epochs``:
    (stage 1, stage 3), default (80, 100) or (2, 4) with ``fast``; ``seed``:
    added to every training seed (the ViT's and the MLPs' 42, member k's
    1000 + k), 0 the JAX script's, the corpus unchanged. ``step`` runs one
    step as :func:`run_digits.run_step` does."""
    dev = resolve_device(device)
    fast = fast or tiny
    on = ["--device", dev.type]
    cfg = os.path.join(REPO, "configs", "synthetic_tiny.yml" if tiny else "synthetic224.yml")
    ds, models, exp = (os.path.join(work, d) for d in ("synth_ds", "models", "exp"))
    log = os.path.join(work, "driver.log")
    counts = corpus or (synth.split_counts(60) if fast else synth.split_counts(250, 600))
    e1, e3 = epochs or (2 if fast else 80, 4 if fast else int(os.environ.get("LADINE_SUITE_E3", "100")))
    dims = TINY_DIMS if tiny else []
    reseed = ["--seed", str(42 + seed)] if seed else []  # the stage-1 CLIs' default is 42
    steps = [0]

    def timed(stage, *a, **k):
        steps[0] += 1
        _add_seconds(work, stage, step(*a, **k))

    _evaluable(counts, cfg)
    os.makedirs(work, exist_ok=True)
    # ---- the corpus ---------------------------------------------------------
    marker = os.path.join(ds, "corpus.json")
    if _read_json(marker) != counts:
        t0 = time.perf_counter()
        synth.write_corpus(ds, counts)
        with open(marker, "w") as f:
            json.dump(counts, f)
        steps[0] += 1
        _add_seconds(work, "corpus", time.perf_counter() - t0)

    # ---- stage 1a: the ViT ------------------------------------------------------
    s1a_log = os.path.join(work, "stage1a.log")
    vit_ckpt = os.path.join(models, "vit_ChestXRay")
    vit_done = lambda: os.path.exists(os.path.join(vit_ckpt, "ladine_meta.json"))  # noqa: E731
    if not vit_done():
        timed("stage1a_vit", CLI + "train_transformer",
              [*on, *dims, "--dataset", "ChestXRay", "--dataroot", ds, "--epochs", str(e1), "--batch_size", "30",
               "--out", models, *reseed], s1a_log, vit_done)
    s1a = last_json(s1a_log) if os.path.exists(s1a_log) else None

    # ---- stage 1b: the mapping MLPs, one a run ------------------------------------
    s1b_log = os.path.join(work, "stage1b.log")
    mlp_dir = os.path.join(models, "ChestXRay", "MLPs")

    def mlp_meta(k):
        return os.path.join(mlp_dir, f"block_{k}", "ladine_meta.json")

    # a bf16 save is exact only where the config computes in bf16 (synthetic224.yml)
    save_dtype = ["--save_dtype", "float32" if tiny else "bfloat16"]
    for k in range(MEMBERS):
        if not os.path.exists(mlp_meta(k)):
            timed("stage1b_mlps", CLI + "train_mapping",
                  [*on, *dims, *(TINY_MLP_DIMS if tiny else []), "--dataset", "ChestXRay", "--dataroot", ds,
                   "--epochs", str(e1), "--batch_size", "30", "--out", models, "--vit_ckpt", vit_ckpt,
                   "--num_members", str(MEMBERS), "--mlp_idx", str(k), *save_dtype, *reseed],
                  s1b_log, lambda k=k: os.path.exists(mlp_meta(k)))
    s1b_accs = []
    for k in range(MEMBERS):
        meta = _read_json(mlp_meta(k)) or {}
        s1b_accs.append(round(meta["accuracy"], 2) if meta.get("accuracy") is not None else "?")

    # ---- the guidance's accuracy -----------------------------------------------------
    g_log = os.path.join(work, "guid.log")
    if not (os.path.exists(g_log) and last_json(g_log)):
        timed("guidance_eval", CLI + "main",
              [*on, "--eval_guidance", "--config", cfg, "--dataroot", ds, "--exp", exp, "--doc", "guid",
               "--vit_ckpt", vit_ckpt, "--mlp_ckpt_dir", mlp_dir], g_log, lambda: last_json(g_log) is not None)
    guid = last_json(g_log)

    # ---- stage 3: the members, one a run ------------------------------------------------
    member_ckpts = []
    for k in range(MEMBERS):
        doc = f"member{k}"
        if best_ckpt(exp, doc) is None:
            done = os.path.join(exp, "logs", doc, "train_complete.json")
            timed("stage3_members", CLI + "main",
                  [*on, "--train", "--config", cfg, "--dataroot", ds, "--exp", exp, "--doc", doc,
                   "--seed", str(1000 + k + seed), "--mlp_idx", str(k), "--n_epochs", str(e3), "--precompute_guidance",
                   "--light_ckpt", "--vit_ckpt", vit_ckpt, "--mlp_ckpt_dir", mlp_dir],
                  log, lambda doc=doc, m=done: os.path.exists(m) and best_ckpt(exp, doc) is not None)
        member_ckpts.append(best_ckpt(exp, doc))

    # the members carry the guidance they trained against
    common = ["--config", cfg, "--dataroot", ds, "--exp", exp, "--diffusion_ckpt", *member_ckpts]
    eval_step = _eval_steps(exp, on, common, log, timed)
    calib = eval_step("calib", ["--calib", "--ddim", "50", "--eta", "1.0"])
    tflag = ["--temperature", str(calib["calibrated_temperature"])]

    # ---- the evaluation battery, one run ----------------------------------------------------
    suite = suite_dict(fast)
    sdir = os.path.join(exp, "logs", "suite")
    run_suite_rows(suite, os.path.join(work, "suite.json"), sdir, [*on], [*tflag, *common], log, timed)
    # the fp32 cover A/B: the bf16 cover row again with every resident weight
    # and the chain in float32 (the tiny config is float32 already)
    if not tiny and "cover" in suite:
        run_suite_rows({"cover_fp32": suite["cover"]}, os.path.join(work, "suite_fp32.json"),
                       os.path.join(exp, "logs", "suite_fp32"), on, [*tflag, *common, "--fp32"], log, timed,
                       "suite_fp32")
    # the EMA weights, calibrated with their own temperature
    ema_calib = eval_step("calib_ema", ["--calib", "--ddim", "50", "--eta", "1.0", "--eval_ema"])
    eval_step("test_ema", ["--test", "--ddim", "50", "--eta", "1.0", "--eval_ema", "--temperature",
                           str(ema_calib["calibrated_temperature"])])

    info = {
        "device": card_line(dev),
        "torch": torch.__version__,
        "config": os.path.relpath(cfg, REPO),
        "corpus": counts,
        "epochs": {"stage1": e1, "stage3": e3},
        **({"seed_offset": seed} if seed else {}),
        "e3_override": os.environ.get("LADINE_SUITE_E3") if not fast else None,
        "stage1a_vit_val_acc": (s1a or {}).get("best_val_accuracy"),
        "stage1b_mlp_val_accs": s1b_accs,
        "guidance_mv_acc": (guid or {}).get("majority_vote_accuracy"),
        "ema_mode": _ema_mode(member_ckpts[0]),
        "stage_seconds": _read_json(os.path.join(work, "stage_seconds.json")) or {},
    }
    with open(os.path.join(work, "results_summary.json"), "w") as f:
        json.dump(info, f, indent=1)
    reports = work_reports(work)
    with open(os.path.join(work, "RESULTS_torch.md"), "w") as f:
        f.write(results_md(info, reports))
    if evidence:
        from ladine_tpu_torch.examples import render_results

        sync_evidence.sync(work, evidence=evidence)
        render_results.write(evidence)
    return {**info, "reports": reports, "steps": steps[0]}


def _eval_steps(exp, on, common, log, timed):
    """``eval_step(doc, flags)``: ``cli.main`` writing ``logs/{doc}/report.json``
    unless it exists; returns the report."""
    def eval_step(doc, extra):
        rpt = os.path.join(exp, "logs", doc, "report.json")
        if not os.path.exists(rpt):
            timed(doc, CLI + "main", [*on, *extra, *common, "--doc", doc], log, lambda: os.path.exists(rpt))
        return _read_json(rpt)

    return eval_step


def run_suite_rows(suite: dict, suite_path: str, sdir: str, on: list, extra: list, log: str, timed,
                   doc: str = "suite") -> None:
    """``cli.main --test --suite`` over the rows of ``suite`` whose report
    is not in ``sdir`` yet (every row on a first run; those a cut run left
    on a resumed one)."""
    def missing():
        return [n for n in suite if not os.path.exists(os.path.join(sdir, f"report_{n}.json"))]

    rows = missing()
    if not rows:
        return
    with open(suite_path, "w") as f:
        json.dump({n: suite[n] for n in rows}, f)
    timed(doc, CLI + "main", [*on, "--test", "--suite", suite_path, *extra, "--doc", doc], log, lambda: not missing())


def results_md(info: dict, reports: Dict[str, dict], reference: Optional[Dict[str, dict]] = None) -> str:
    """The run as markdown: the stages, the table of :mod:`render_results`
    (with the JAX run's mv-acc and ECE beside each row where ``reference``
    has them) and each stage's wall seconds beside the card."""
    from ladine_tpu_torch.examples.render_results import table_lines

    e, c = info["epochs"], info["corpus"]
    accs = info["stage1a_vit_val_acc"], info["guidance_mv_acc"]
    full = "224" in info["config"]
    lines = [
        "# RESULTS — full-pipeline evidence run of the PyTorch port (synthetic 224x224"
        + (", parity dims)" if full else ", tiny widths)"),
        "",
        "The three-stage pipeline of `ladine_tpu_torch` on the brightness-matched synthetic 2-class",
        "corpus (`ladine_tpu_torch/examples/make_synth_medical.py`, the pixels of",
        "`scripts/make_synth_medical.py`), at the widths of " + f"`{info['config']}`: "
        + ("ViT-B/16 guidance, 5 mapping MLPs (150528->4096->2048->128), 5 members (150528->4096"
           " encoder, T=1000), MC trials 20, test batch 70 (drop_last)." if full
           else "the tiny widths (a wiring check, not evidence)."),
        f"Corpus: {2 * c['training']} training, {2 * c['validation']} validation, {2 * c['testing']} test images.",
        f"The analytic Bayes-optimal accuracy is **{100 * synth.bayes_accuracy():.2f}%**.",
        "Reproduce: `python -m ladine_tpu_torch.examples.run_results --work <dir> --evidence evidence`.",
        *([f"NOTE: member epochs overridden to {e['stage3']} (LADINE_SUITE_E3)."] if info.get("e3_override") else []),
        *([f"NOTE: training seeds offset by {info['seed_offset']} (the ViT's and the MLPs' "
           f"{42 + info['seed_offset']}, member k's {1000 + info['seed_offset']} + k); the corpus is the same."]
          if info.get("seed_offset") else []),
        "",
        f"- device: {info['device']}; torch {info['torch']}",
        f"- epochs: stage 1 (ViT, MLPs) {e['stage1']}, stage 3 (members) {e['stage3']}",
        "- stage-1a best val accuracy: " + ("—" if accs[0] is None else f"**{accs[0]:.2f}%**"),
        f"- stage-1b best val accuracies: {info['stage1b_mlp_val_accs']}",
        "- guidance majority-vote accuracy: " + ("—" if accs[1] is None else f"**{accs[1]:.2f}%**"),
        f"- EMA rows: {info['ema_mode']} weights",
        "",
        *table_lines(reports, reference),
        "",
        f"Wall seconds by stage on {info['device']}: "
        + ", ".join(f"{k} {v:.1f}" for k, v in info["stage_seconds"].items()) + ".",
    ]
    if reference:
        lines += ["", "JAX columns: the JAX package's run on a TPU (`evidence/report_*.json`, `RESULTS.md`).",
                  "Fresh initialization draws from torch generators, so the weights differ from the JAX run's."]
    return "\n".join(lines) + "\n"


def run_real(args, step: Callable = run_step) -> str:
    """Reference artifacts on real data: the reference ``.pth`` tree through
    ``cli.convert``, ``--calib`` at DDIM-50, the suite at the fitted
    temperature, ``RESULTS_REAL.md`` in ``--work`` (returned)."""
    dev = resolve_device(args.device)
    on = ["--device", dev.type]
    w = args.work
    os.makedirs(w, exist_ok=True)
    log = os.path.join(w, "driver.log")
    cfg = args.config or os.path.join(
        REPO, "configs", "chest_x_ray.yml" if args.dataset == "ChestXRay" else "isic_skin_cancer.yml")
    diffu = args.diffusion_pths or sorted(glob.glob(os.path.join(args.pretrained_dir, "diffu*_ckpt_best*.pth")))
    if not diffu:
        raise SystemExit(f"no diffu*_ckpt_best*.pth under {args.pretrained_dir}; pass them with --diffusion_pths")

    conv = os.path.join(w, "converted")
    guidance = os.path.join(conv, f"guidance_{args.dataset}")
    members = [os.path.join(conv, f"member_{k}") for k in range(len(diffu))]

    def converted():
        return all(os.path.exists(os.path.join(p, "ladine_meta.json")) for p in [guidance, *members])

    if not converted():
        step(CLI + "convert", [*on, "--pretrained_dir", args.pretrained_dir, "--dataset", args.dataset,
                               "--config", cfg, "--diffusion_ckpt", *diffu, "--out", conv],
             os.path.join(w, "convert.log"), converted)

    exp = os.path.join(w, "exp")
    common = ["--config", cfg, "--dataroot", args.dataroot, "--exp", exp, "--guidance_ckpt", guidance,
              "--diffusion_ckpt", *members]
    eval_step = _eval_steps(exp, on, common, log, lambda stage, *a, **k: step(*a, **k))
    calib = eval_step("calib", ["--calib", "--ddim", "50", "--eta", "1.0"])
    temp = calib["calibrated_temperature"]
    suite = suite_dict(args.fast)
    sdir = os.path.join(exp, "logs", "suite")
    run_suite_rows(suite, os.path.join(w, "suite.json"), sdir, on, ["--temperature", str(temp), *common], log,
                   lambda stage, *a, **k: step(*a, **k))

    def row(name):
        return _read_json(os.path.join(sdir, f"report_{name}.json"))

    lines = [
        f"# RESULTS_REAL — reference weights + real data ({args.dataset}), the PyTorch port",
        "",
        f"Artifacts: `{args.pretrained_dir}` ({len(diffu)} diffusion members,",
        f"converted via `cli.convert`), data root `{args.dataroot}`,",
        f"device {card_line(dev)}. Calibrated temperature (cached-sample",
        f"Nelder-Mead on the validation split): **{temp:.4f}** (val ECE {calib['ece']:.4f}).",
        "",
        "| evaluation | acc % | mv-acc % | ECE | NLL | Brier |",
        "|---|---|---|---|---|---|",
        md_row("clean, full 1000-step chain (parity workload)", row("full")),
        md_row("clean, DDIM-50 eta=1 (serving sampler)", row("d50")),
    ]
    if (r := row("int8")) is not None:
        lines.append(md_row("clean, DDIM-50, int8 eps matmuls (--int8)", r))
    for name in CORRUPTION_ROWS:
        if (r := row(name)) is not None:
            lines.append(md_row(f"corruption: {name}", r))
    for name, label in (("atk_fgsm", "FGSM"), ("atk_pgd", "PGD")):
        if (r := row(name)) is not None:
            lines.append(md_row(f"attack: {label} (eps 0.03, white-box ViT)", r))
    lines += uncertainty_lines({
        "clean (DDIM-50)": row("d50"),
        **{f"corruption: {n}": row(n) for n in CORRUPTION_ROWS},
        "attack: FGSM": row("atk_fgsm"),
        "attack: PGD": row("atk_pgd"),
    })
    lines += ["", "Compare these rows with the reference's `test_atk` logs for the same checkpoints",
              "and data (classification_train_separately.py:631-840)."]
    out = os.path.join(w, "RESULTS_REAL.md")
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", type=str, default="_results_run")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--fast", action="store_true", help="fewer epochs and rows (a wiring check)")
    ap.add_argument("--tiny", action="store_true", help="configs/synthetic_tiny.yml's widths; implies --fast")
    ap.add_argument("--evidence", type=str, default=None,
                    help="then copy the reports into DIR/torch and render DIR/RESULTS_torch.md, beside the "
                         "JAX rows of DIR/report_*.json")
    ap.add_argument("--real", action="store_true",
                    help="evaluate reference artifacts on real data instead of the synthetic pipeline")
    ap.add_argument("--pretrained_dir", type=str, default=None,
                    help="with --real: the reference pretrained/{task}_ckpt tree (ViT, MLPs/, diffu*.pth)")
    ap.add_argument("--dataroot", type=str, default=None,
                    help="with --real: ImageFolder root (training/validation/testing)")
    ap.add_argument("--dataset", type=str, default="ChestXRay")
    ap.add_argument("--config", type=str, default=None,
                    help="with --real: YAML config pinning the model dims (default by --dataset)")
    ap.add_argument("--diffusion_pths", type=str, nargs="*", default=None,
                    help="with --real: the reference diffu*.pth files in member order")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.real:
        if not (args.pretrained_dir and args.dataroot):
            raise SystemExit("--real needs --pretrained_dir and --dataroot")
        print(f"wrote {run_real(args)}")
        return 0
    out = run(args.work, args.device, args.fast, args.tiny, args.evidence)
    print(f"wrote {os.path.join(args.work, 'RESULTS_torch.md')} ({out['steps']} steps run)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
