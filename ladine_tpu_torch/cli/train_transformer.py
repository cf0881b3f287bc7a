"""Stage-1a CLI: fine-tune the backbone.

    python -m ladine_tpu_torch.cli.train_transformer --dataset ChestXRay \
        --dataroot DATA --out ./models [--model_arch vit] [--device cuda]

Counterpart of ``ladine_tpu/cli/train_transformer.py``, with its flags
(``--cpu`` becomes ``--device``, default ``cuda``): AdamW lr 1e-4 wd 0.1,
StepLR(10, 0.5), cross-entropy, the best validation accuracy's weights
saved as ``{out}/vit_{dataset}`` (``{out}/{model_arch}_{dataset}`` for the
other backbones), ``{"params": <state dict>}`` in float32, with
``"batch_stats"`` beside them for a BatchNorm backbone (the JAX CLI saves
the params alone). Every ``--model_arch`` of the JAX CLI: ``vit``,
``deit``, ``deit_distilled``, ``convit`` (16 heads, GPSA in the first
``min(10, max(depth - 2, 1))`` blocks), ``efficientnetv2``
(``--effnet_variant``), ``resnet18`` and ``resnet50``, with its ``--demo``
geometry. The backbones train in float32, as the JAX CLI's; attention
(the ViT, DeiT, ConViT's MHSA tail) goes through K3. The later stages take
the ViT only: they read ``vit_{dataset}``.
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
                   help="backbone family: the JAX CLI's seven choices")
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


def build_backbone(args, img: int, patch: int, embed: int, depth: int, heads: int) -> torch.nn.Module:
    """The ``--model_arch`` backbone in float32 on the meta device (the
    trainer's compute module), at the JAX CLI's geometry."""
    from ladine_tpu_torch.models import ViT
    from ladine_tpu_torch.models.backbones import ConViT, DeiT, EfficientNetV2
    from ladine_tpu_torch.models.encoders import ResNet

    kw = dict(device="meta", dtype=torch.float32)
    arch, c = args.model_arch, args.num_classes
    if arch == "vit":
        return ViT(c, img, patch, embed, depth, heads, **kw)
    if arch in ("deit", "deit_distilled"):
        return DeiT(c, img, patch, embed, depth, heads, distilled=arch == "deit_distilled", **kw)
    if arch == "convit":
        # convit_base: 16 heads, GPSA in the first 10 of 12 blocks
        return ConViT(c, img, patch, embed, depth, num_heads=heads if args.demo else 16,
                      local_layers=min(10, max(depth - 2, 1)), **kw)
    if arch == "efficientnetv2":
        return EfficientNetV2(c, args.effnet_variant, width_mult=0.125 if args.demo else 1.0,
                              depth_mult=0.15 if args.demo else 1.0, **kw)
    return ResNet(c, arch, **kw)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ladine_tpu_torch.device import cli_device

    dev = cli_device(args.device)

    from ladine_tpu_torch.cli._common import Splits, synchronize, to_device
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
    vit = build_backbone(args, img, patch, embed, depth, heads)
    splits = Splits(args, img)
    tx = make_optimizer("AdamW", step_decay(args.lr, args.step_size, args.gamma,
                                            splits.steps_per_epoch(args.batch_size)),
                        weight_decay=args.weight_decay, grad_clip=None)
    state = create_vit_state(vit, torch.Generator(device=dev).manual_seed(args.seed), tx, device=dev)
    train_step, eval_step = make_vit_train_step(vit, tx), make_vit_eval_step(vit)

    best_acc, best, best_epoch = -1.0, None, -1
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
            correct += float(eval_step(state.params, *to_device(images, labels, dev), state.batch_stats))
            total += len(labels)
        val_acc = 100.0 * correct / max(total, 1)
        logger.info(f"epoch {epoch}: train loss {loss:.4f} val acc {val_acc:.2f}%")
        if val_acc > best_acc:
            best_acc, best_epoch = val_acc, epoch
            best = {"params": state.params}
            if state.batch_stats is not None:
                best["batch_stats"] = state.batch_stats
            best = {name: {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}
                    for name, tensors in best.items()}
    path = os.path.join(args.out, f"{args.model_arch}_{args.dataset}")
    save_checkpoint(path, best, {"epoch": best_epoch, "accuracy": best_acc, "kind": "vit"})
    logger.info(f"saved best {args.model_arch} (epoch {best_epoch}, acc {best_acc:.2f}%) to {path}")
    print(json.dumps({"mode": "train_transformer", "best_val_accuracy": best_acc, "last_loss": loss,
                      "train_seconds": train_seconds, "train_images": images_seen}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
