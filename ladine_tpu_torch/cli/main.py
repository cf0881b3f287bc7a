"""Main CLI: the diffusion stage's command line.

    python -m ladine_tpu_torch.cli.main --config configs/synthetic224.yml \
        --train --vit_ckpt ./models/vit_ChestXRay --mlp_ckpt_dir ./models/ChestXRay/MLPs
    python -m ladine_tpu_torch.cli.main --config ... --test --diffusion_ckpt RUN/diffu_all0_ckpt_best_...
    python -m ladine_tpu_torch.cli.main --config ... --calib --cached_samples RUN/samples.npz

Counterpart of ``ladine_tpu/cli/main.py``, with its flags; JAX's ``--cpu``
becomes ``--device`` (default ``cuda``: without a card the command exits
with a message unless it is given ``--device cpu``). Modes:

    --train           train the diffusion members (all together, or --mlp_idx)
    --test            nested-ensemble robust evaluation (--suite, --sweep)
    --calib           temperature calibration (live, or --cached_samples)
    --demo            the selected mode on tiny models and synthetic data

Corruption and attack flags: --noise_perturbation, --low_resolution,
--brightness, --contrast, --covered K N, --crop, --attack_name, --epsilon.
Sampler and precision: --ddim N, --eta, --bf16/--fp32, --int8,
--int8_encode. Accepted and ignored: --pallas (the port's ViT always runs
its attention kernel), --low_mem_mode, --ni, --thread.

``--set section.key=value`` is strict here (``ROADMAP.md`` §3 D3): an
unknown section or leaf exits, a value is a float only where the field is,
and ``--set data.seed=...`` wins over ``--seed``.

On N cards, one rank a card:

    torchrun --nproc_per_node N -m ladine_tpu_torch.cli.main --config ... --train [--fsdp]

Under ``torchrun`` (``WORLD_SIZE`` > 1) ``main`` initializes the process
group, ``nccl`` on ``--device cuda`` with ``cuda:LOCAL_RANK``, ``gloo`` on
``--device cpu`` (a group the caller initialized first is used as it is);
the runner trains and evaluates on the ('member', 'data') mesh
(``parallel/``), and rank 0 alone writes files and prints.
"""

from __future__ import annotations

import argparse
import builtins
import dataclasses
import json
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ladine-tpu diffusion stage (PyTorch)")
    p.add_argument("--config", type=str, default=None, help="YAML config (reference format accepted)")
    p.add_argument("--exp", type=str, default="./exp", help="experiment dir")
    p.add_argument("--doc", type=str, default="run", help="run name (log subdir)")
    p.add_argument("--seed", type=int, default=4444)
    p.add_argument("--dataroot", type=str, default=None)
    p.add_argument("--preprocess", type=str, default="grayscaled", choices=["grayscaled", "standardized"])
    p.add_argument("--train", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--calib", action="store_true")
    p.add_argument("--tune_T", action="store_true",
                   help="with --calib: also fit a softplus temperature by NLL on the samples")
    p.add_argument("--save_samples", action="store_true",
                   help="with --test/--calib: dump the raw MC samples + labels to samples.npz in the log dir")
    p.add_argument("--cached_samples", type=str, default=None,
                   help="with --calib: recalibrate from a samples.npz dump without re-running inference")
    p.add_argument("--make_plots", action="store_true",
                   help="with --test/--calib: reliability / PIW / qq figures into the log dir (needs matplotlib)")
    p.add_argument("--demo", action="store_true", help="tiny models + synthetic data")
    p.add_argument("--mlp_idx", type=int, default=None, help="train only this member; default all")
    p.add_argument("--guidance_ckpt", type=str, default=None, help="a full SEViTGuidance checkpoint")
    p.add_argument("--vit_ckpt", type=str, default=None,
                   help="stage-1a ViT checkpoint; with --mlp_ckpt_dir the guidance is assembled from stage 1")
    p.add_argument("--mlp_ckpt_dir", type=str, default=None, help="stage-1b directory holding block_0..block_{K-1}")
    p.add_argument("--diffusion_ckpt", type=str, nargs="*", default=None,
                   help="ONE training checkpoint (diffu_all*/diffu{k}*) or several, or K per-member variable "
                        "checkpoints")
    p.add_argument("--eval_ema", action="store_true", help="evaluate/validate the debiased EMA weights")
    p.add_argument("--resume_training", type=str, default=None, help="checkpoint dir to resume training from")
    p.add_argument("--allow_random_init", action="store_true",
                   help="with --test/--calib: permit evaluating randomly initialized members/guidance")
    p.add_argument("--pretrain_guidance", type=int, default=0,
                   help="CE-pretrain the guidance heads for N steps before diffusion training")
    p.add_argument("--joint_train", action="store_true",
                   help="CE-update the guidance heads alongside every diffusion step")
    p.add_argument("--light_ckpt", action="store_true",
                   help="with --train: best checkpoints carry only params/EMA/batch stats in the compute dtype "
                        "(no optimizer state): evaluable and exportable, not resumable")
    p.add_argument("--precompute_guidance", action="store_true",
                   help="with --train: run the frozen guidance over the train/valid splits once, cache y0_hat, "
                        "and train without the guidance resident")
    p.add_argument("--export_predictor", action="store_true",
                   help="package the ensemble as a Predictor artifact in the log dir (after --train: the best "
                        "checkpoint; with --test/--calib: the weights and knobs evaluated)")
    p.add_argument("--eval_guidance", action="store_true", help="report guidance majority-vote accuracy and exit")
    p.add_argument("--set", action="append", default=[], metavar="K=V", dest="set_overrides",
                   help="dotted-path config override, repeatable (e.g. --set optim.lowmem=true); strict: "
                        "applied after the YAML file and the dedicated flags")
    p.add_argument("--timesteps", type=int, default=None)
    p.add_argument("--ddim", type=int, default=0, help="strided sampler steps (0 = full chain)")
    p.add_argument("--eta", type=float, default=None, help="strided-sampler stochasticity (default 1.0)")
    p.add_argument("--val_ddim", type=int, default=None,
                   help="stride the VALIDATION sampler only during --train (0/unset = follow --ddim)")
    p.add_argument("--skip_type", type=str, default=None, choices=["uniform", "quad"])
    p.add_argument("--noise_prior", action="store_true", help="zero prior mean at T")
    p.add_argument("--noise_prior_sample_only", action="store_true",
                   help="with --noise_prior: the zero prior only at sampling, not in the training q_sample")
    p.add_argument("--no_cat_f_phi", action="store_true",
                   help="do not concatenate the guidance prediction onto the eps-net y-branch input")
    p.add_argument("--n_epochs", type=int, default=None)
    p.add_argument("--noise_perturbation", type=float, default=0.0)
    p.add_argument("--low_resolution", type=int, default=1)
    p.add_argument("--brightness", type=float, default=0.0)
    p.add_argument("--contrast", type=float, default=1.0)
    p.add_argument("--covered", type=float, nargs=2, default=[0.0, 0], metavar=("K", "N"))
    p.add_argument("--crop", type=float, default=0.0)
    p.add_argument("--suite", type=str, default=None,
                   help="with --test: JSON file of named EvalConfig overrides ({name: {field: value}}), all run "
                        "on one load, report_<name>.json written as each finishes")
    p.add_argument("--sweep", type=str, default=None, metavar="PARAM=V1,V2,...",
                   help="with --test: sweep one corruption severity, e.g. noise=0,0.1,0.2 | lowres=1,2,4 | "
                        "brightness=... | contrast=... | crop=...")
    p.add_argument("--attack_name", type=str, default=None,
                   choices=["FGSM", "PGD", "BIM", "LinfBIM", "L2PGD", "CW", "AUTOPGD"])
    p.add_argument("--epsilon", type=float, default=0.03)
    p.add_argument("--mc_trials", type=int, default=None)
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--fp32", action="store_true", help="force model.dtype=float32 over the config")
    p.add_argument("--pallas", action="store_true", help="accepted; the port's ViT always runs its attention kernel")
    p.add_argument("--int8", action="store_true", help="with --test/--calib: int8 lin2/lin3 (kernels/int8.py)")
    p.add_argument("--int8_encode", action="store_true", help="with --test/--calib: int8 enc_lin1 and mapping heads")
    p.add_argument("--fsdp", action="store_true",
                   help="on a mesh of ranks (torchrun): shard the large leaves of the train state over the data "
                        "axis too")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--low_mem_mode", action="store_true", help="accepted for compatibility")
    p.add_argument("--ni", action="store_true", help="non-interactive (compat no-op)")
    p.add_argument("--thread", type=int, default=4, help="compat no-op")
    p.add_argument("--verbose", type=str, default="INFO")
    return p


def _json_sanitize(obj):
    """NaN -> None, so report.json stays strict JSON (empty PIW/variance
    groups are NaN by design)."""
    import math

    if isinstance(obj, float) and math.isnan(obj):
        return None
    if isinstance(obj, dict):
        return {k: _json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_json_sanitize(v) for v in obj]
    return obj


def build_config(args):
    """The run's Config: the YAML file, then the dedicated flags, then
    ``--seed``, then the strict ``--set`` overrides (so ``--set
    data.seed=...`` wins)."""
    from ladine_tpu_torch.config import Config

    cfg = Config.from_yaml(args.config) if args.config else Config()
    if args.dataroot:
        cfg.data.dataroot = args.dataroot
    cfg.data.preprocess = args.preprocess
    if args.timesteps:
        cfg.diffusion.timesteps = args.timesteps
    if args.n_epochs:
        cfg.training.n_epochs = args.n_epochs
    if args.ddim:
        cfg.diffusion.ddim_steps = args.ddim
    if args.eta is not None:
        cfg.diffusion.ddim_eta = args.eta
    if args.val_ddim is not None:
        cfg.diffusion.val_ddim_steps = args.val_ddim
    if args.skip_type:
        cfg.diffusion.skip_type = args.skip_type
    if args.noise_prior:
        cfg.diffusion.noise_prior = True
    if args.noise_prior_sample_only:
        if not (args.noise_prior or cfg.diffusion.noise_prior):
            raise SystemExit("--noise_prior_sample_only requires --noise_prior (it selects WHERE the noise "
                             "prior applies)")
        cfg.diffusion.noise_prior_training = False
    if args.no_cat_f_phi:
        cfg.diffusion.include_guidance = False
    if args.bf16 and args.fp32:
        raise SystemExit("--bf16 and --fp32 are mutually exclusive")
    if args.bf16:
        cfg.model.dtype = "bfloat16"
    if args.fp32:
        cfg.model.dtype = "float32"
    if args.pallas:
        cfg.model.use_pallas = True
    if args.fsdp:
        cfg.model.fsdp = True
    if args.mc_trials:
        cfg.testing.mc_trials = args.mc_trials
    cfg.data.seed = args.seed
    cfg.apply_cli_overrides(args.set_overrides)
    return cfg


def _is_train_ckpt(p: str) -> bool:
    from ladine_tpu_torch.utils import load_checkpoint_meta

    return load_checkpoint_meta(p).get("kind") == "diffusion_members"


def _write_report(log_dir: str, result: dict, name: str = "report.json") -> None:
    """The report, written by rank 0 alone under a process group."""
    from ladine_tpu_torch.parallel.mesh import is_writer

    if is_writer():
        with open(os.path.join(log_dir, name), "w") as f:
            json.dump(result, f, indent=2)


def _report_row(rep: dict) -> dict:
    return {"accuracy": rep["mean_confidence_accuracy"], "mv_accuracy": rep["majority_vote_accuracy"],
            "ece": rep["ece"], "nll": rep["nll"], "brier": rep["brier"]}


def _plots(report: dict, log_dir: str) -> None:
    from ladine_tpu_torch.utils.plots import save_evaluation_plots

    for pth in save_evaluation_plots(report, log_dir):
        print(f"wrote {pth}", file=sys.stderr)


def eval_config(args, cfg, temperature: float):
    """The ``EvalConfig`` of the evaluation flags over the config's sampler
    (a ``--suite`` row replaces fields of it)."""
    from ladine_tpu_torch.infer import EvalConfig

    return EvalConfig(
        mc_trials=cfg.testing.mc_trials, temperature=temperature, noise_std=args.noise_perturbation,
        low_resolution=args.low_resolution, brightness=args.brightness, contrast=args.contrast,
        cover=(args.covered[0], int(args.covered[1])), crop=args.crop, attack_name=args.attack_name,
        attack_eps=args.epsilon, ddim_steps=cfg.diffusion.ddim_steps, ddim_eta=cfg.diffusion.ddim_eta,
        skip_type=cfg.diffusion.skip_type, noise_prior=cfg.diffusion.noise_prior, use_int8=args.int8,
        use_int8_encode=args.int8_encode,
    )


def train_ckpt_weights(runner, args, train_ckpts, eval_cfg):
    """The members of training checkpoints, stacked, and the guidance
    (``--guidance_ckpt``/``--vit_ckpt``, else the one the first checkpoint
    trained against), in the compute dtype's layout; ``eval_cfg`` with the
    guidance head each stacked member trained against. Returns
    (stacked, gvars, eval_cfg)."""
    stacked, g_tree, head_ids = runner.load_members_from_train_ckpts(train_ckpts, use_ema=args.eval_ema,
                                                                     eval_cast=True)
    if head_ids is None:
        head_ids = tuple(range(next(iter(stacked.values())).shape[0]))
    if tuple(head_ids) != tuple(range(runner.config.diffusion.num_members)):
        eval_cfg = dataclasses.replace(eval_cfg, head_indices=tuple(head_ids))
    if args.guidance_ckpt or args.vit_ckpt:
        gvars = runner.init_guidance(None, args.guidance_ckpt, vit_ckpt=args.vit_ckpt,
                                     mlp_dir=args.mlp_ckpt_dir, eval_cast=True)
    else:
        gvars = {"params": runner.to_eval_vars(g_tree["params"], runner.guidance, eval_cast=True)}
    return stacked, gvars, eval_cfg


def _init_distributed(device: str) -> tuple:
    """Under ``torchrun`` (``WORLD_SIZE`` > 1, no group yet): initialize the
    default process group, ``nccl`` with ``cuda:LOCAL_RANK`` for a card,
    ``gloo`` for the CPU. Returns (the device string of this rank, whether
    this call made the group)."""
    import datetime

    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return device, False
    if device.startswith("cuda"):
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    if dist.is_initialized():
        return device, False
    import torch

    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    # a rank waits at a barrier while rank 0 writes a checkpoint
    dist.init_process_group("nccl" if device.startswith("cuda") else "gloo", timeout=datetime.timedelta(minutes=30))
    return device, True


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ladine_tpu_torch.device import cli_device

    device, made_group = _init_distributed(args.device)
    try:
        return _main(args, cli_device(device))
    finally:
        if made_group:
            import torch.distributed as dist

            dist.destroy_process_group()


def _main(args, dev) -> int:
    cfg = build_config(args)
    if args.make_plots:
        from ladine_tpu_torch.utils.plots import require_matplotlib

        try:
            require_matplotlib()
        except RuntimeError as e:
            raise SystemExit(str(e)) from None

    import torch

    from ladine_tpu_torch.cli.runner import Runner

    log_dir = os.path.join(args.exp, "logs", args.doc)
    runner = Runner(cfg, log_dir=log_dir, demo=args.demo, device=dev)
    writer = runner.writer

    def print(*a, **k):  # rank 0 alone prints, under a process group
        if writer:
            builtins.print(*a, **k)

    if writer:
        cfg.save_yaml(os.path.join(log_dir, "config.yml"))
    if args.temperature:
        runner.temperature = args.temperature

    def generator():
        """A fresh CPU generator of the run's seed: every evaluation draws
        the same streams, as the JAX CLI passes one key to each."""
        return torch.Generator().manual_seed(args.seed)

    eval_cfg = eval_config(args, cfg, runner.temperature)

    if args.eval_guidance:
        random_demo = args.demo and args.guidance_ckpt is None
        gvars = runner.init_guidance(torch.Generator(device=dev).manual_seed(0), args.guidance_ckpt,
                                     vit_ckpt=args.vit_ckpt, mlp_dir=args.mlp_ckpt_dir, eval_cast=not random_demo)
        if random_demo:
            gvars = runner.pretrain_guidance(gvars)
        acc = runner.evaluate_guidance(gvars)
        print(json.dumps({"mode": "eval_guidance", "majority_vote_accuracy": acc}))
        return 0

    if args.train:
        result = runner.train(args.seed, guidance_ckpt=args.guidance_ckpt, epochs=cfg.training.n_epochs,
                              resume_from=args.resume_training, pretrain_guidance_steps=args.pretrain_guidance,
                              member_idx=args.mlp_idx, joint_train=args.joint_train, eval_ema=args.eval_ema,
                              vit_ckpt=args.vit_ckpt, mlp_dir=args.mlp_ckpt_dir,
                              precompute_yhat=args.precompute_guidance, light_ckpt=args.light_ckpt)
        summary = {"mode": "train", "best_accuracy": result["best_accuracy"], "steps": result["steps"],
                   "best_ckpt_path": result["best_ckpt_path"], "train_seconds": result["train_seconds"],
                   "train_images": result["images"], "last_losses": result["last_losses"]}
        if args.export_predictor:
            from ladine_tpu_torch.infer import Predictor
            from ladine_tpu_torch.train import ema_read

            if result.get("best_ckpt_path"):
                # the BEST checkpoint: the reported best_accuracy is its own
                stacked, gvars, _ = runner.load_members_from_train_ckpt(
                    result["best_ckpt_path"], use_ema=args.eval_ema, eval_cast=True)
            else:
                print("warning: no best checkpoint saved; exporting final-epoch weights", file=sys.stderr)
                s, gvars = result["states"], result["guidance"]
                if gvars is None:
                    gvars = runner.init_guidance(None, args.guidance_ckpt, vit_ckpt=args.vit_ckpt,
                                                 mlp_dir=args.mlp_ckpt_dir, eval_cast=True)
                params = (ema_read(s.ema, cfg.model.ema_rate, s.step, result.get("ema_init", "zero"))
                          if args.eval_ema else s.params)
                stacked = {**params, **s.batch_stats}
            predictor = Predictor(
                guidance=runner.guidance_module(gvars), model=runner.members_module(stacked), sched=runner.sched,
                temperature=runner.temperature, mc_trials=cfg.testing.mc_trials,
                ddim_steps=cfg.diffusion.ddim_steps or 50, ddim_eta=cfg.diffusion.ddim_eta,
                head_indices=(args.mlp_idx,) if args.mlp_idx is not None else None, device=dev)
            artifact = os.path.join(log_dir, "predictor_artifact")
            if writer:
                predictor.save(artifact)
            summary["predictor_artifact"] = artifact
        print(json.dumps(summary))
        return 0

    if args.tune_T and not args.calib:
        print("--tune_T only applies with --calib", file=sys.stderr)
        return 2

    if args.calib and args.cached_samples:
        # offline recalibration: a reweighting of an earlier dump, no models
        from ladine_tpu_torch.infer import compute_report, temperature_search, tune_temperature_nll

        dump = np.load(args.cached_samples)
        t_best, _ = temperature_search(dump["samples"], dump["labels"])
        report = compute_report(dump["samples"], dump["labels"], t_best)
        report["calibrated_temperature"] = t_best
        if args.tune_T:
            report["nll_tuned_temperature"] = tune_temperature_nll(dump["samples"], dump["labels"])
        if args.make_plots and writer:
            _plots(report, log_dir)
        printable = {k: v for k, v in report.items() if k not in ("samples", "labels")}
        result = _json_sanitize({"mode": "calib_cached", **printable})
        _write_report(log_dir, result)
        print(json.dumps(result))
        return 0

    if args.test or args.calib:
        train_ckpts = (args.diffusion_ckpt if args.diffusion_ckpt and all(map(_is_train_ckpt, args.diffusion_ckpt))
                       else None)
        if train_ckpts:
            stacked, gvars, eval_cfg = train_ckpt_weights(runner, args, train_ckpts, eval_cfg)
        else:
            if args.eval_ema:
                print("--eval_ema needs a training checkpoint (diffu_all*); per-member variable checkpoints "
                      "carry no EMA", file=sys.stderr)
                return 2
            if not args.demo and not args.allow_random_init:
                missing = []
                if not args.diffusion_ckpt:
                    missing.append("members (--diffusion_ckpt)")
                if not (args.guidance_ckpt or args.vit_ckpt):
                    missing.append("guidance (--guidance_ckpt or --vit_ckpt)")
                if missing:
                    print("refusing to evaluate randomly initialized " + " and ".join(missing)
                          + "; pass --allow_random_init to override", file=sys.stderr)
                    return 2
            gvars = runner.init_guidance(torch.Generator(device=dev).manual_seed(0), args.guidance_ckpt,
                                         vit_ckpt=args.vit_ckpt, mlp_dir=args.mlp_ckpt_dir, eval_cast=True)
            stacked = runner.init_members(torch.Generator(device=dev).manual_seed(1), args.diffusion_ckpt,
                                          eval_cast=True)
        if args.export_predictor:
            # the EVALUATED configuration, packaged for serving
            from ladine_tpu_torch.infer import Predictor

            exp_stacked, exp_hi = stacked, eval_cfg.head_indices
            if eval_cfg.selected_members is not None:
                sel = torch.tensor(eval_cfg.selected_members)
                exp_stacked = {k: v.index_select(0, sel.to(v.device)) for k, v in stacked.items()}
                exp_hi = tuple(eval_cfg.selected_members)
            predictor = Predictor(
                guidance=runner.guidance_module(gvars), model=runner.members_module(exp_stacked),
                sched=runner.sched, temperature=eval_cfg.temperature, mc_trials=eval_cfg.mc_trials,
                ddim_steps=eval_cfg.ddim_steps, ddim_eta=eval_cfg.ddim_eta, skip_type=eval_cfg.skip_type,
                noise_prior=eval_cfg.noise_prior, use_int8=eval_cfg.use_int8,
                use_int8_encode=eval_cfg.use_int8_encode, head_indices=exp_hi, device=dev)
            artifact = os.path.join(log_dir, "predictor_artifact")
            if writer:
                predictor.save(artifact)
            print(f"exported predictor -> {artifact}", file=sys.stderr)
            del predictor
        if args.test and args.suite:
            with open(args.suite) as f:
                suite = json.load(f)
            rows = {}
            for name, overrides in suite.items():
                overrides = {k: tuple(v) if isinstance(v, list) else v for k, v in overrides.items()}
                rep = runner.test(generator(), stacked, gvars, dataclasses.replace(eval_cfg, **overrides))
                rep.pop("samples", None), rep.pop("labels", None)
                # each row's report as it finishes: a killed run keeps its rows
                _write_report(log_dir, _json_sanitize(rep), f"report_{name}.json")
                rows[name] = _report_row(rep)
                print(json.dumps({"suite_row": name, **rows[name]}), file=sys.stderr)
            result = _json_sanitize({"mode": "suite", "rows": rows})
            _write_report(log_dir, result)
            print(json.dumps(result))
            return 0
        if args.test and args.sweep:
            param, _, values = args.sweep.partition("=")
            field_map = {"noise": "noise_std", "lowres": "low_resolution", "brightness": "brightness",
                         "contrast": "contrast", "crop": "crop"}
            if param not in field_map:
                print(f"unknown sweep param {param!r}; one of {sorted(field_map)}", file=sys.stderr)
                return 2
            if args.make_plots or args.save_samples:
                print("note: --make_plots/--save_samples are not applied in --sweep mode (per-severity reports "
                      "only)", file=sys.stderr)
            caster = int if param == "lowres" else float
            rows = []
            for v in [caster(x) for x in values.split(",")]:
                rep = runner.test(generator(), stacked, gvars, dataclasses.replace(eval_cfg, **{field_map[param]: v}))
                rows.append({param: v, **_report_row(rep)})
            result = {"mode": "sweep", "param": param, "rows": rows}
            _write_report(log_dir, result)
            print(json.dumps(result))
            return 0
        if args.test:
            report = runner.test(generator(), stacked, gvars, eval_cfg)
        else:
            report = runner.calibrate(generator(), stacked, gvars, eval_cfg)
        if args.calib and args.tune_T:
            from ladine_tpu_torch.infer import tune_temperature_nll

            report["nll_tuned_temperature"] = tune_temperature_nll(report["samples"], report["labels"])
        if args.save_samples and writer:
            np.savez_compressed(os.path.join(log_dir, "samples.npz"), samples=report["samples"],
                                labels=report["labels"])
        if args.make_plots and writer:
            _plots(report, log_dir)
        printable = {k: v for k, v in report.items() if k not in ("samples", "labels")}
        result = _json_sanitize({"mode": "test" if args.test else "calib", **printable})
        _write_report(log_dir, result)
        print(json.dumps(result))
        return 0

    print("nothing to do: pass --train, --test or --calib (add --demo for a smoke run)", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
