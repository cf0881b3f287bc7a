"""Convert the reference's PyTorch artifacts into the port's runner
checkpoints (and a ``Predictor`` artifact), and back.

Counterpart of ``ladine_tpu/cli/convert.py``, with its flags (``--cpu``
becomes ``--device``, default ``cuda``; it places the ``Predictor`` of
``--export_predictor``). The reference's artifact tree:

    pretrained/{task}_ckpt/vit_base_patch16_224_{DS}.pth   whole-module pickle
    pretrained/{task}_ckpt/MLPs/<sorted listing>           K whole-module pickles
    .../diffu{k}_ckpt_best_eph{E}_acc{A}.pth               {'noise_estimator': sd, ...}

    python -m ladine_tpu_torch.cli.convert \\
        --pretrained_dir /path/to/chest_x_ray_ckpt --dataset ChestXRay \\
        --diffusion_ckpt diffu0_*.pth diffu1_*.pth ... \\
        --out ./converted [--config configs/chest_x_ray.yml] [--export_predictor]

writes under ``--out``: ``guidance_{DS}`` (``{"params": SEViTGuidance
state dict}``, for ``--guidance_ckpt``), ``member_{k}`` (a stacked
``ConditionalModel`` state dict of one member, for ``--diffusion_ckpt``)
and, with ``--export_predictor``, ``predictor_artifact`` (``Predictor.load``).
Each is checked against the config's model (``diffusion.include_guidance``
sets lin1's width).

``--export`` writes the port's checkpoints back into the reference's
formats:

    python -m ladine_tpu_torch.cli.convert --export --out ./for_reference \\
        --guidance_ckpt <guidance or assembled ckpt> \\
        --diffusion_ckpt <diffu_all*/diffu{k}* training ckpts, or member_{k}> [--eval_ema]

    for_reference/vit_base_patch16_224_{DS}.pth   timm state dict
    for_reference/MLPs/block_{k}.pth              Classifier state dicts
    for_reference/diffu{k}_ckpt_best_eph{E}_acc{A}.pth   {'noise_estimator': sd, ...}

(the reference's stage-1 pickles are whole modules: load the state dict
into a timm module and pickle that; ``utils.torch_convert.export_vit``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def build_parser():
    p = argparse.ArgumentParser(description="reference .pth -> ladine-tpu (PyTorch port) checkpoints")
    p.add_argument("--pretrained_dir", type=str, default=None,
                   help="reference pretrained/{task}_ckpt dir (ViT pickle + MLPs/)")
    p.add_argument("--vit_pth", type=str, default=None, help="explicit ViT .pth (overrides the conventional name)")
    p.add_argument("--mlp_pths", type=str, nargs="*", default=None,
                   help="explicit mapping-MLP .pth files in member order")
    p.add_argument("--diffusion_ckpt", type=str, nargs="*", default=None,
                   help="reference diffu{k}_ckpt_best_*.pth files in member order")
    p.add_argument("--dataset", type=str, default="ChestXRay")
    p.add_argument("--config", type=str, default=None, help="YAML config pinning the model dims (default: full size)")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--export_predictor", action="store_true",
                   help="also package guidance + members + schedule + the dataset's calibrated temperature as "
                        "a Predictor artifact (needs the guidance and --diffusion_ckpt)")
    p.add_argument("--export", action="store_true",
                   help="REVERSE direction: the port's checkpoints -> reference .pth artifacts")
    p.add_argument("--guidance_ckpt", type=str, default=None,
                   help="with --export: a guidance/assembled checkpoint to write out as ViT + MLP .pth files")
    p.add_argument("--eval_ema", action="store_true", help="with --export: export the debiased EMA parameters")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def _member_pth_name(idx: int, meta: dict) -> str:
    return f"diffu{idx}_ckpt_best_eph{meta.get('epoch', 0)}_acc{meta.get('accuracy', 0.0):.4f}.pth"


def run_export(args) -> int:
    """The port's checkpoints -> the reference's torch artifacts."""
    from ladine_tpu_torch.train import ema_params_from_ckpt
    from ladine_tpu_torch.utils import load_checkpoint
    from ladine_tpu_torch.utils.torch_convert import (
        export_conditional_model,
        export_mapping_mlp,
        export_vit,
        save_torch_state_dict,
    )

    os.makedirs(args.out, exist_ok=True)
    written = {}
    if args.guidance_ckpt:
        tree, _ = load_checkpoint(args.guidance_ckpt)
        gp = tree["params"] if "params" in tree else tree
        vit_path = os.path.join(args.out, f"vit_base_patch16_224_{args.dataset}.pth")
        save_torch_state_dict(export_vit(gp), vit_path)
        mlps_dir = os.path.join(args.out, "MLPs")
        os.makedirs(mlps_dir, exist_ok=True)
        mlp_paths = []
        while f"mlps.{len(mlp_paths)}.layers.0.weight" in gp:
            k = len(mlp_paths)
            mlp_paths.append(os.path.join(mlps_dir, f"block_{k}.pth"))
            save_torch_state_dict(export_mapping_mlp(gp, k), mlp_paths[-1])
        written["vit"], written["mlps"] = vit_path, mlp_paths
        print(f"exported guidance -> {vit_path} + {len(mlp_paths)} MLPs", file=sys.stderr)

    if args.diffusion_ckpt:
        paths = []
        for pth in args.diffusion_ckpt:
            tree, meta = load_checkpoint(pth)
            if "states" in tree:  # a training checkpoint: stacked member states
                st = tree["states"]
                params = ema_params_from_ckpt(st, meta) if args.eval_ema else st["params"]
                stacked = {**params, **st["batch_stats"]}
                idx = meta.get("member_idx")
            else:  # this CLI's member_{k}: a stacked state dict
                stacked, idx, meta = tree, None, {}
            for i in range(next(iter(stacked.values())).shape[0]):
                dst = os.path.join(args.out, _member_pth_name(len(paths) if idx is None else idx, meta))
                save_torch_state_dict(export_conditional_model(stacked, i), dst, wrapper_key="noise_estimator",
                                      epoch=meta.get("epoch", 0))
                paths.append(dst)
        written["members"] = paths
        print(f"exported {len(paths)} diffusion members", file=sys.stderr)

    if not written:
        raise SystemExit("--export needs --guidance_ckpt and/or --diffusion_ckpt")
    print(json.dumps({"mode": "export", **written}))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ladine_tpu_torch.device import cli_device

    dev = cli_device(args.device)
    if args.export:
        return run_export(args)

    from ladine_tpu_torch.config import Config
    from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance
    from ladine_tpu_torch.utils import save_checkpoint, validate_guidance_tree
    from ladine_tpu_torch.utils.torch_convert import (
        guidance_from_reference,
        load_torch_state_dict,
        member_from_reference,
    )

    cfg = Config.from_yaml(args.config) if args.config else Config()
    m = cfg.model
    written = {}

    # ---- guidance (ViT + K mapping MLPs) -------------------------------
    vit_pth, mlp_pths = args.vit_pth, args.mlp_pths
    if args.pretrained_dir:
        if vit_pth is None:
            vit_pth = os.path.join(args.pretrained_dir, f"vit_base_patch16_224_{args.dataset}.pth")
        if mlp_pths is None:
            mlps_root = os.path.join(args.pretrained_dir, "MLPs")
            # the reference iterates the SORTED listing
            mlp_pths = [os.path.join(mlps_root, f) for f in sorted(os.listdir(mlps_root))]
    gsd = guidance_kw = None
    if vit_pth:
        if not mlp_pths:
            raise SystemExit("need mapping-MLP .pth files alongside the ViT")
        gsd = guidance_from_reference(load_torch_state_dict(vit_pth), [load_torch_state_dict(p) for p in mlp_pths])
        guidance_kw = dict(num_classes=cfg.data.num_classes, num_members=len(mlp_pths), vit_depth=m.vit_depth,
                           img_size=m.image_size, patch_size=m.patch_size, embed_dim=m.embed_dim,
                           num_heads=m.num_heads, mlp_hidden_dims=tuple(m.mlp_hidden_dims))
        template = SEViTGuidance(**guidance_kw, device="meta", dtype=torch.float32).state_dict()
        gvars = validate_guidance_tree({"params": gsd}, template)
        gpath = os.path.join(args.out, f"guidance_{args.dataset}")
        save_checkpoint(gpath, gvars, {"kind": "guidance", "num_members": len(mlp_pths), "source": vit_pth})
        written["guidance"] = gpath
        print(f"converted guidance ({len(mlp_pths)} MLPs) -> {gpath}", file=sys.stderr)

    # ---- diffusion members ---------------------------------------------
    members = []
    if args.diffusion_ckpt:
        cond = ConditionalModel(1, m.image_size * m.image_size * 3, m.feature_dim, m.hidden_dim,
                                cfg.data.num_classes, cfg.diffusion.timesteps + 1,
                                guidance=cfg.diffusion.include_guidance, device="meta", dtype=torch.float32)
        template = cond.state_dict()
        paths = []
        for k, pth in enumerate(args.diffusion_ckpt):
            sd = {key: v.unsqueeze(0) for key, v in member_from_reference(load_torch_state_dict(pth)).items()}
            sd = validate_guidance_tree({"params": sd}, template, what=f"member {pth}")["params"]
            mpath = os.path.join(args.out, f"member_{k}")
            save_checkpoint(mpath, sd, {"kind": "diffusion_member", "member": k, "source": pth})
            members.append(sd)
            paths.append(mpath)
            print(f"converted member {k} -> {mpath}", file=sys.stderr)
        written["members"] = paths

    # ---- serving artifact -----------------------------------------------
    if args.export_predictor:
        if gsd is None or not members:
            raise SystemExit("--export_predictor needs both guidance and members")
        from ladine_tpu_torch.data import CALIBRATED_TEMPERATURE, base_dataset
        from ladine_tpu_torch.infer import Predictor
        from ladine_tpu_torch.ops import DiffusionSchedule

        d = cfg.diffusion
        sched = DiffusionSchedule.create(d.beta_schedule, d.timesteps, d.beta_start, d.beta_end, device=dev)
        try:
            temperature = CALIBRATED_TEMPERATURE[base_dataset(args.dataset)]
        except (ValueError, KeyError):
            temperature = 0.2555
        guidance = SEViTGuidance(**guidance_kw, device="meta", dtype=torch.float32)
        guidance.load_state_dict(gvars["params"], assign=True)
        model = cond.like(len(members), "meta", torch.float32)
        model.load_state_dict({k: torch.cat([p[k] for p in members]) for k in members[0]}, assign=True)
        predictor = Predictor(guidance=guidance, model=model, sched=sched, temperature=temperature,
                              mc_trials=cfg.testing.mc_trials, ddim_steps=d.ddim_steps or 50,
                              ddim_eta=d.ddim_eta, device=dev)
        apath = os.path.join(args.out, "predictor_artifact")
        predictor.save(apath)
        written["predictor"] = apath
        print(f"packaged predictor -> {apath}", file=sys.stderr)

    if not written:
        raise SystemExit("nothing to convert: pass --pretrained_dir/--vit_pth and/or --diffusion_ckpt")
    print(json.dumps({"mode": "convert", **written}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
