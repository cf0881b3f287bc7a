"""Stage-1b CLI: train the mapping MLPs on the frozen ViT's taps.

    python -m ladine_tpu_torch.cli.train_mapping --dataset ChestXRay \
        --dataroot DATA --vit_ckpt ./models/vit_ChestXRay --out ./models

Counterpart of ``ladine_tpu/cli/train_mapping.py``, with its flags
(``--cpu`` becomes ``--device``, default ``cuda``): Adam lr 1e-3 (ChestXRay)
or 5e-4 (ISIC), StepLR(20, 0.5), cross-entropy, each MLP's best validation
weights saved as ``{out}/{dataset}/MLPs/block_{k}`` (``{"params":
<MappingMLP state dict>}``, float32). All K MLPs train together on one
tapped frozen-ViT forward a batch (float32, as the JAX CLI's); ``--mlp_idx``
trains one, ``--sequential`` all K one at a time. A member's best weights
are copied to the host when they improve, so the card holds one state.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description="ladine-tpu mapping-MLP training (stage 1b)")
    p.add_argument("--dataset", type=str, default="ChestXRay")
    p.add_argument("--dataroot", type=str, default=None)
    p.add_argument("--preprocess", type=str, default="grayscaled")
    p.add_argument("--vit_ckpt", type=str, default=None, help="stage-1a checkpoint")
    p.add_argument("--epochs", type=int, default=301)
    p.add_argument("--batch_size", type=int, default=30)
    p.add_argument("--lr", type=float, default=None, help="default 1e-3 (ChestXRay) / 5e-4 (ISIC)")
    p.add_argument("--step_size", type=int, default=20)
    p.add_argument("--gamma", type=float, default=0.5)
    p.add_argument("--num_members", type=int, default=5)
    p.add_argument("--mlp_idx", type=int, default=None,
                   help="train ONE mapping MLP (tap depth k+1), the reference's per-MLP workflow")
    p.add_argument("--sequential", action="store_true",
                   help="train all K MLPs one at a time in this process (one state resident); members "
                        "whose block_k checkpoint exists are skipped")
    p.add_argument("--save_dtype", choices=("float32", "bfloat16"), default="float32",
                   help="bfloat16: round the saved weights to bf16 values (stored as float32)")
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", type=str, default="./models")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--embed_dim", type=int, default=768)
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--num_heads", type=int, default=12)
    p.add_argument("--mlp_hidden_dims", type=int, nargs="*", default=None,
                   help="mapping-MLP hidden widths (default 4096 2048 128)")
    p.add_argument("--demo", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.sequential and args.mlp_idx is not None:
        parser.error("--sequential trains ALL members; it cannot be combined with --mlp_idx (pick one)")
    from ladine_tpu_torch.device import cli_device

    dev = cli_device(args.device)
    if args.lr is None:
        args.lr = 5e-4 if "ISIC" in args.dataset else 1e-3

    from ladine_tpu_torch.cli._common import Splits, synchronize, to_device
    from ladine_tpu_torch.models import MappingMLP, ViT, init_random_
    from ladine_tpu_torch.train import (
        create_mapping_states,
        make_mapping_eval_step,
        make_mapping_train_step,
        make_optimizer,
        step_decay,
    )
    from ladine_tpu_torch.utils import load_checkpoint, save_checkpoint, setup_logging

    logger = setup_logging(args.out)
    if args.demo:
        img, patch, embed, heads, depth = 16, 8, 16, 2, args.num_members
        mlp_dims = (16, 8, 8)
        args.epochs = min(args.epochs, 3)
    else:
        img, patch, embed = args.image_size, args.patch_size, args.embed_dim
        heads, depth = args.num_heads, args.depth
        mlp_dims = tuple(args.mlp_hidden_dims) if args.mlp_hidden_dims else (4096, 2048, 128)

    vit = ViT(args.num_classes, img, patch, embed, depth, heads, device=dev, dtype=torch.float32)
    init_random_(vit, torch.Generator(device=dev).manual_seed(0))
    if args.vit_ckpt:
        tree, _ = load_checkpoint(args.vit_ckpt)
        vit.load_state_dict(tree["params"])
        logger.info(f"loaded frozen ViT from {args.vit_ckpt}")
    mlp = MappingMLP(vit.num_patches * embed, args.num_classes, mlp_dims, device="meta", dtype=torch.float32)
    splits = Splits(args, img)
    tx = make_optimizer("Adam", step_decay(args.lr, args.step_size, args.gamma,
                                           splits.steps_per_epoch(args.batch_size)), grad_clip=None)
    timing = {"train_seconds": 0.0, "train_images": 0}

    def train_member_set(members):
        """Train the member set (None: all K) together; save each member's
        best checkpoint and return their accuracies."""
        ids = list(members) if members is not None else list(range(args.num_members))
        states = create_mapping_states(mlp, torch.Generator(device=dev).manual_seed(args.seed), tx,
                                       args.num_members, member_indices=members, device=dev)
        train_step = make_mapping_train_step(vit, mlp, tx, args.num_members, member_indices=members)
        eval_step = make_mapping_eval_step(vit, mlp, args.num_members, member_indices=members)
        best = np.full(len(ids), -1.0)
        best_params = [None] * len(ids)
        for epoch in range(args.epochs):
            t0 = time.perf_counter()
            for images, labels in splits.batches("train", args.batch_size, shuffle=True, seed=epoch):
                states, losses, _ = train_step(states, *to_device(images, labels, dev))
                timing["train_images"] += len(labels)
            synchronize(dev)
            timing["train_seconds"] += time.perf_counter() - t0
            losses = losses.float().cpu().numpy()
            timing["last_losses"] = losses.tolist()
            correct, total = np.zeros(len(ids)), 0
            for images, labels in splits.batches("valid", args.batch_size):
                correct += eval_step(states.params, *to_device(images, labels, dev)).cpu().numpy()
                total += len(labels)
            val_acc = 100.0 * correct / max(total, 1)
            logger.info(f"epoch {epoch}: train losses {np.round(losses, 4).tolist()} val accs "
                        f"{np.round(val_acc, 2).tolist()} (members {ids})")
            for k in range(len(ids)):
                if val_acc[k] > best[k]:
                    best[k] = val_acc[k]
                    best_params[k] = {n: v[k].detach().to("cpu", copy=True) for n, v in states.params.items()}
        del states
        for k, member in enumerate(ids):
            host = best_params[k]
            if args.save_dtype == "bfloat16":
                host = {n: v.to(torch.bfloat16).float() for n, v in host.items()}
            path = os.path.join(args.out, args.dataset, "MLPs", f"block_{member}")
            save_checkpoint(path, {"params": host},
                            {"member": member, "accuracy": float(best[k]), "kind": "mapping_mlp"})
            logger.info(f"saved MLP {member} (acc {best[k]:.2f}%) to {path}")
        return best.tolist()

    if args.sequential:
        accs = []
        for k in range(args.num_members):
            meta_p = os.path.join(args.out, args.dataset, "MLPs", f"block_{k}", "ladine_meta.json")
            if os.path.exists(meta_p):
                with open(meta_p) as f:
                    acc = json.load(f).get("accuracy")
                logger.info(f"MLP {k} already trained (acc {acc}); skipping")
                accs.append(acc)
                continue
            accs.extend(train_member_set((k,)))
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        print(json.dumps({"mode": "train_mapping", "sequential": True, "best_val_accuracies": accs, **timing}))
        return 0

    members = (args.mlp_idx,) if args.mlp_idx is not None else None
    best = train_member_set(members)
    print(json.dumps({"mode": "train_mapping", "mlp_idx": args.mlp_idx, "best_val_accuracies": best, **timing}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
