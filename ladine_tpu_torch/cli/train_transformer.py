"""Stage-1a CLI: fine-tune the ViT backbone.

    python -m ladine_tpu_torch.cli.train_transformer --dataset ChestXRay \
        --dataroot DATA --out ./models [--device cuda]

Counterpart of ``ladine_tpu/cli/train_transformer.py``, with its flags
(``--cpu`` becomes ``--device``, default ``cuda``): AdamW lr 1e-4 wd 0.1,
StepLR(10, 0.5), cross-entropy, the best validation accuracy's weights
saved as ``{out}/vit_{dataset}`` (``{"params": <ViT state dict>}``, float32).
The ViT trains in float32 (as the JAX CLI's), its attention through K3.
Only ``--model_arch vit`` is ported; the other backbones wait for
``models/backbones.py`` (ROADMAP.md slice E item 15).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch


def build_parser():
    p = argparse.ArgumentParser(description="ladine-tpu ViT fine-tune (stage 1a)")
    p.add_argument("--dataset", type=str, default="ChestXRay")
    p.add_argument("--dataroot", type=str, default=None)
    p.add_argument("--preprocess", type=str, default="grayscaled")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=30)
    p.add_argument("--eval_batch_size", type=int, default=70)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.1)
    p.add_argument("--step_size", type=int, default=10)
    p.add_argument("--gamma", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--model_arch", type=str, default="vit",
                   choices=["vit", "resnet18", "resnet50", "efficientnetv2", "deit", "deit_distilled", "convit"],
                   help="backbone family; only vit is ported (the others: ROADMAP.md slice E item 15)")
    p.add_argument("--effnet_variant", type=str, default="l", choices=["s", "m", "l"])
    p.add_argument("--out", type=str, default="./models")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--embed_dim", type=int, default=768)
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--num_heads", type=int, default=12)
    p.add_argument("--demo", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ladine_tpu_torch.device import cli_device

    dev = cli_device(args.device)
    if args.model_arch != "vit":
        raise SystemExit(f"--model_arch {args.model_arch}: the port has only the ViT backbone; the others wait "
                         "for models/backbones.py and models/encoders.py (ROADMAP.md slice E item 15)")

    from ladine_tpu_torch.cli._common import Splits, synchronize, to_device
    from ladine_tpu_torch.models import ViT
    from ladine_tpu_torch.train import (
        create_vit_state,
        make_optimizer,
        make_vit_eval_step,
        make_vit_train_step,
        step_decay,
    )
    from ladine_tpu_torch.utils import save_checkpoint, setup_logging

    logger = setup_logging(args.out)
    if args.demo:
        img, patch, embed, heads, depth = 16, 8, 16, 2, 2
        args.epochs = min(args.epochs, 3)
    else:
        img, patch, embed = args.image_size, args.patch_size, args.embed_dim
        heads, depth = args.num_heads, args.depth
    vit = ViT(args.num_classes, img, patch, embed, depth, heads, device="meta", dtype=torch.float32)
    splits = Splits(args, img)
    tx = make_optimizer("AdamW", step_decay(args.lr, args.step_size, args.gamma,
                                            splits.steps_per_epoch(args.batch_size)),
                        weight_decay=args.weight_decay, grad_clip=None)
    state = create_vit_state(vit, torch.Generator(device=dev).manual_seed(args.seed), tx, device=dev)
    train_step, eval_step = make_vit_train_step(vit, tx), make_vit_eval_step(vit)

    best_acc, best_params, best_epoch = -1.0, None, -1
    train_seconds, images_seen = 0.0, 0
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        for images, labels in splits.batches("train", args.batch_size, shuffle=True, seed=epoch):
            state, loss, _ = train_step(state, *to_device(images, labels, dev))
            images_seen += len(labels)
        synchronize(dev)
        train_seconds += time.perf_counter() - t0
        loss = float(loss)
        correct = total = 0
        for images, labels in splits.batches("valid", args.eval_batch_size):
            correct += float(eval_step(state.params, *to_device(images, labels, dev)))
            total += len(labels)
        val_acc = 100.0 * correct / max(total, 1)
        logger.info(f"epoch {epoch}: train loss {loss:.4f} val acc {val_acc:.2f}%")
        if val_acc > best_acc:
            best_acc, best_epoch = val_acc, epoch
            best_params = {k: v.detach().to("cpu", copy=True) for k, v in state.params.items()}
    path = os.path.join(args.out, f"vit_{args.dataset}")
    save_checkpoint(path, {"params": best_params}, {"epoch": best_epoch, "accuracy": best_acc, "kind": "vit"})
    logger.info(f"saved best ViT (epoch {best_epoch}, acc {best_acc:.2f}%) to {path}")
    print(json.dumps({"mode": "train_transformer", "best_val_accuracy": best_acc, "last_loss": loss,
                      "train_seconds": train_seconds, "train_images": images_seen}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
