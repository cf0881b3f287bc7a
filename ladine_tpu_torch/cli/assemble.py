"""Guidance-checkpoint assembly CLI.

Forward (stage 1 -> stage 3):

    python -m ladine_tpu_torch.cli.assemble \
        --vit_ckpt ./models/vit_ChestXRay \
        --mlp_ckpt_dir ./models/ChestXRay/MLPs \
        --out ./models/guidance_ChestXRay

Inverse (a trained guidance -> the stage-1 layout, e.g. from a
``--pretrain_guidance`` or ``--joint_train`` run):

    python -m ladine_tpu_torch.cli.assemble --split ./models/guidance_ChestXRay \
        --dataset ChestXRay --out ./models

Counterpart of ``ladine_tpu/cli/assemble.py``, on the port's checkpoints
(``utils/assemble.py``). It moves tensors between files on the host only.
"""

from __future__ import annotations

import argparse
import json


def build_parser():
    p = argparse.ArgumentParser(description="ladine-tpu guidance assembly")
    p.add_argument("--vit_ckpt", type=str, default=None,
                   help="stage-1a ViT checkpoint (cli.train_transformer output)")
    p.add_argument("--mlp_ckpt_dir", type=str, default=None, help="stage-1b directory holding block_0..block_{K-1}")
    p.add_argument("--mlp_ckpts", type=str, nargs="*", default=None,
                   help="explicit per-member MLP checkpoints, in member order")
    p.add_argument("--num_members", type=int, default=None, help="expected K (checked; inferred when omitted)")
    p.add_argument("--out", type=str, required=True,
                   help="output: guidance checkpoint path (forward) or stage-1 output dir (--split)")
    p.add_argument("--split", type=str, default=None,
                   help="INVERSE mode: guidance checkpoint to split back into stage-1 artifacts")
    p.add_argument("--dataset", type=str, default="ChestXRay", help="dataset name in the stage-1 layout (--split)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ladine_tpu_torch.utils import assemble_guidance, export_guidance_stage1, load_checkpoint, save_checkpoint

    if args.split:
        gvars, _ = load_checkpoint(args.split)
        paths = export_guidance_stage1(gvars, args.out, args.dataset)
        print(json.dumps({"mode": "split", "paths": paths}))
        return 0
    if not args.vit_ckpt:
        raise SystemExit("--vit_ckpt is required (or use --split)")
    gvars = assemble_guidance(args.vit_ckpt, mlp_dir=args.mlp_ckpt_dir, mlp_ckpts=args.mlp_ckpts,
                              num_members=args.num_members)
    n = len({k.split(".")[1] for k in gvars["params"] if k.startswith("mlps.")})
    save_checkpoint(args.out, gvars, {"kind": "guidance", "num_members": n})
    print(json.dumps({"mode": "assemble", "out": args.out, "num_members": n}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
