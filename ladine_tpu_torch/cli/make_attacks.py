"""Write pre-computed adversarial test sets.

Counterpart of ``ladine_tpu/cli/make_attacks.py``, with its flags (``--cpu``
becomes ``--device``, default ``cuda``). The reference evaluates on
``Test_attacks_{name}/`` ImageFolder trees; this runs a white-box attack
(``attacks/``) against the stage-1 ViT over the clean test split and writes
the adversarial images back as such a tree:

    python -m ladine_tpu_torch.cli.make_attacks --dataroot /data/chestxray \\
        --attack_name PGD --epsilon 0.03 --guidance_ckpt ./models/vit_ChestXRay

Output: ``{dataroot}/Test_attacks_{name}/{class}/{i}.png``, written by
``data/png.py`` (no Pillow needed). Test images that need Pillow to decode
(another size or format than ``data/png.py`` reads) make the command exit
non-zero with a message, before it attacks anything, where Pillow is not
installed.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description="generate Test_attacks_{name} datasets")
    p.add_argument("--dataset", type=str, default="ChestXRay")
    p.add_argument("--dataroot", type=str, required=True)
    p.add_argument("--preprocess", type=str, default="grayscaled")
    p.add_argument("--attack_name", type=str, required=True,
                   choices=["FGSM", "PGD", "BIM", "LinfBIM", "L2PGD", "CW", "AUTOPGD"])
    p.add_argument("--epsilon", type=float, default=0.03)
    p.add_argument("--guidance_ckpt", type=str, default=None,
                   help="the stage-1 ViT checkpoint (train_transformer's vit_{dataset}, or a guidance)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default=None, help="output root (default: {dataroot}/Test_attacks_{name})")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--demo", action="store_true", help="tiny ViT geometry (for smoke runs on small images)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ladine_tpu_torch.device import cli_device

    dev = cli_device(args.device)
    from ladine_tpu_torch.data.imagefolder import pillow_missing_for, png_writer

    write = png_writer()

    from ladine_tpu_torch.attacks import make_attack
    from ladine_tpu_torch.data import open_dataset
    from ladine_tpu_torch.models import ViT
    from ladine_tpu_torch.utils import load_checkpoint, setup_logging

    logger = setup_logging(None)
    if not args.guidance_ckpt and not args.demo:
        build_parser().error("--guidance_ckpt is required (attacking a randomly initialized ViT produces "
                             "meaningless adversarial datasets); use --demo for smoke runs")
    img = args.image_size
    if args.demo:
        vit = ViT(2, img, max(img // 2, 8), 16, 2, 2, device=dev, dtype=torch.float32)
    else:
        vit = ViT(2, img, device=dev, dtype=torch.float32)
    if args.guidance_ckpt:
        tree, _ = load_checkpoint(args.guidance_ckpt)
        params = tree["params"]
        if any(k.startswith("vit.") for k in params):  # a guidance: its ViT
            params = {k[len("vit."):]: v for k, v in params.items() if k.startswith("vit.")}
        vit.load_state_dict(params)
        logger.info(f"attacking ViT from {args.guidance_ckpt}")
    else:
        from ladine_tpu_torch.models import init_random_

        init_random_(vit, torch.Generator(device=dev).manual_seed(0))

    # attacks work in [0, 1] pixel space (bounds and the saved images); a ViT
    # trained on standardized inputs sees them normalized inside logits_fn
    if args.preprocess == "standardized":
        from ladine_tpu_torch.data import NORM_STATS, base_dataset

        mean, std = (torch.as_tensor(np.asarray(v), dtype=torch.float32, device=dev)
                     for v in NORM_STATS[base_dataset(args.dataset)])

        def logits_fn(x):
            return vit((x - mean) / std)
    else:
        logits_fn = vit
    attack = make_attack(args.attack_name, args.epsilon, logits_fn)

    ds = open_dataset(args.dataset, args.dataroot, "test",
                      "raw" if args.preprocess == "standardized" else args.preprocess, image_size=(img, img))
    if pillow_missing_for(getattr(ds, "paths", ()), (img, img)):
        raise SystemExit("these images need Pillow to decode or resize (data/png.py reads 8-bit PNGs at the "
                         "target size), and it is not installed here; install Pillow or run where it is")
    out_root = args.out or os.path.join(args.dataroot, f"Test_attacks_{args.attack_name}")
    counts = {str(c): 0 for c in ds.classes}
    n_success = n_total = 0
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    for images, labels in ds.batches(args.batch_size):
        x = torch.as_tensor(np.asarray(images), dtype=torch.float32, device=dev)
        y = torch.as_tensor(np.asarray(labels), dtype=torch.int64, device=dev)
        adv, success = attack(x, y, generator)
        adv = adv.detach().clamp(0.0, 1.0).cpu().numpy()
        n_success += int(success.sum())
        n_total += len(labels)
        for i, lab in enumerate(np.asarray(labels)):
            # ImageFolder classes are directory names; the array datasets' ints become them
            cls = str(ds.classes[int(lab)])
            d = os.path.join(out_root, cls)
            os.makedirs(d, exist_ok=True)
            write((adv[i] * 255.0).round().astype(np.uint8), os.path.join(d, f"{counts[cls]}.png"))
            counts[cls] += 1
    logger.info(f"wrote {n_total} adversarial images to {out_root} "
                f"({args.attack_name} eps={args.epsilon}, fooled {n_success}/{n_total})")
    print(json.dumps({"mode": "make_attacks", "attack": args.attack_name, "out": out_root, "images": n_total,
                      "attack_success_rate": round(n_success / max(n_total, 1), 4)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
