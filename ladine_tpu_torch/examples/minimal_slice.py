"""The smallest end-to-end slice of the port:

    one image -> the ViT's taps and heads -> mapping MLP 0's guidance ->
    member 0 -> a 50-step DDIM reverse chain (T = 1000, 4 MC trials) ->
    class probabilities and the majority vote.

The port's counterpart of ``examples/minimal_slice.py``, every layer once,
on random weights drawn from seeded generators (load trained checkpoints
or convert reference ``.pth`` weights for real use). The default sizes are
reduced but keep the structure (32 px, patch 8, embed 32, depth 5, 4
heads; 64-wide member); ``--full-size`` gives ViT-B/16 and 4096-wide
shapes, for the card.

    python -m ladine_tpu_torch.examples.minimal_slice [--full-size] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import torch

from ladine_tpu_torch.device import resolve_device
from ladine_tpu_torch.infer.engine import nested_ensemble_sample
from ladine_tpu_torch.metrics import convert_to_prob, majority_vote
from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance, init_random_
from ladine_tpu_torch.ops import DiffusionSchedule, ddim_timesteps

T, DDIM_STEPS, TRIALS = 1000, 50, 4
TEMPERATURE = 0.1737
SMALL = dict(img=32, patch=8, embed=32, heads=4, depth=5, feat=64, mlp_dims=(64, 32, 16))
FULL = dict(img=224, patch=16, embed=768, heads=12, depth=12, feat=4096, mlp_dims=(4096, 2048, 128))


def build(full_size: bool = False, device="cuda", seed: int = 0):
    """(image (1, H, W, 3), guidance, member 0) on random weights from
    generators seeded ``seed``, ``seed + 1`` and ``seed + 2``."""
    dev = resolve_device(device)
    s = FULL if full_size else SMALL
    image = torch.rand((1, s["img"], s["img"], 3), generator=torch.Generator().manual_seed(seed)).to(dev)
    guidance = SEViTGuidance(num_classes=2, num_members=5, vit_depth=s["depth"], img_size=s["img"],
                             patch_size=s["patch"], embed_dim=s["embed"], num_heads=s["heads"],
                             mlp_hidden_dims=s["mlp_dims"], device=dev)
    init_random_(guidance, torch.Generator(device=dev).manual_seed(seed + 1))
    member = ConditionalModel(1, s["img"] * s["img"] * 3, s["feat"], s["feat"], 2, T + 1, device=dev)
    init_random_(member, torch.Generator(device=dev).manual_seed(seed + 2))
    return image, guidance.eval(), member.eval()


@torch.no_grad()
def run(image: torch.Tensor, guidance: SEViTGuidance, member: ConditionalModel, seed: int = 3,
        noise: Optional[torch.Tensor] = None, verbose: bool = True) -> dict:
    """The slice on ``image``: the six guidance heads' probabilities, member
    0's MC samples (TRIALS, 1, 2) from a DDIM-50 chain (eta 0) conditioned
    on head 0, each trial's probabilities at ``TEMPERATURE``, their mean and
    the majority vote. ``noise``: injected draws (51, 1, TRIALS, 1, 2), or
    None to draw them from a generator seeded ``seed``."""
    dev = image.device
    heads = torch.softmax(guidance(image).float(), dim=-1)  # (6, 1, 2)
    y0_hat = heads[0]  # member 0's guidance, (1, 2)
    sched = DiffusionSchedule.create("linear", T, 1e-4, 0.02, device=dev)
    tau = ddim_timesteps(T, DDIM_STEPS)
    t0 = time.perf_counter()
    samples = nested_ensemble_sample(member, image.reshape(1, -1), y0_hat[None], sched, TRIALS, tau=tau,
                                     generator=torch.Generator(device=dev).manual_seed(seed), noise=noise)[0]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    probs = convert_to_prob(samples, TEMPERATURE)
    out = {"guidance": heads[:, 0], "samples": samples, "probs": probs, "mean": probs.mean(0),
           "vote": majority_vote(samples), "seconds": seconds}
    if verbose:
        print("guidance heads:", heads[:, 0].cpu().numpy().round(3).tolist())
        print(f"{TRIALS} MC samples via {DDIM_STEPS}-step DDIM in {seconds:.1f}s")
        print("raw sample logits:", samples[:, 0].cpu().numpy().round(3).tolist())
        print("per-trial probabilities:", probs[:, 0].cpu().numpy().round(3).tolist())
        print("mean probability:", out["mean"][0].cpu().numpy().round(3).tolist())
        print("majority vote:", int(out["vote"][0]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(*build(args.full_size, args.device))
    return 0 if bool(torch.isfinite(out["samples"]).all()) else 1


if __name__ == "__main__":
    sys.exit(main())
