"""Attack dispatch, mirroring the reference's Attack class surface and its
AutoAttack APGD path: the counterpart of ``ladine_tpu/attacks/__init__.py``.

``make_attack(name, epsilon, logits_fn)`` returns ``attack(x, labels,
generator=None, x_init=None) -> (adv_images, success)``; ``generator`` feeds
the random starts (PGD, L2PGD, AUTOPGD) and ``x_init`` injects a start.
``random_start(name, x, epsilon, generator)`` is the start such an attack
draws, so that a caller can draw it for a whole batch and attack a part of
it (the evaluator on a mesh)."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ladine_tpu_torch.attacks.autopgd import apgd_ce
from ladine_tpu_torch.attacks.cw import cw_l2
from ladine_tpu_torch.attacks.gradient import bim, fgsm, l2_bim, l2_start, l2pgd, linf_bim, linf_start, pgd

ATTACKS = ("FGSM", "PGD", "BIM", "LinfBIM", "L2PGD", "CW", "AUTOPGD")


def make_attack(name: str, epsilon: float, logits_fn) -> Callable:
    """The attack of the reference's mode ``name`` at ``epsilon`` against
    ``logits_fn`` (the full ViT forward in the reference)."""
    if name == "FGSM":
        return lambda x, labels, generator=None, x_init=None: fgsm(logits_fn, x, labels, epsilon)
    if name == "PGD":
        return lambda x, labels, generator=None, x_init=None: pgd(
            logits_fn, x, labels, epsilon, generator, x_init=x_init)
    if name == "BIM":
        # the reference's BIM mode is foolbox's **L2** basic iterative
        # attack; LinfBIM is the Linf variant
        return lambda x, labels, generator=None, x_init=None: l2_bim(logits_fn, x, labels, epsilon)
    if name == "LinfBIM":
        return lambda x, labels, generator=None, x_init=None: linf_bim(logits_fn, x, labels, epsilon)
    if name == "L2PGD":
        return lambda x, labels, generator=None, x_init=None: l2pgd(
            logits_fn, x, labels, epsilon, generator, x_init=x_init)
    if name == "CW":
        # the reference consumes foolbox's eps-clipped second return; a
        # non-positive eps runs unclipped
        eps_cw = epsilon if epsilon and epsilon > 0 else None
        return lambda x, labels, generator=None, x_init=None: cw_l2(logits_fn, x, labels, epsilon=eps_cw)
    if name == "AUTOPGD":
        return lambda x, labels, generator=None, x_init=None: apgd_ce(
            logits_fn, x, labels, epsilon, generator, x_init=x_init)
    raise ValueError(f"unknown attack {name!r}; one of {ATTACKS}")


def random_start(name: str, x: torch.Tensor, epsilon: float,
                 generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
    """The start point that attack ``name`` draws for ``x`` from
    ``generator`` (its ``x_init``), or None for an attack without one."""
    if name in ("PGD", "AUTOPGD"):
        return linf_start(x, epsilon, generator)
    if name == "L2PGD":
        return l2_start(x, epsilon, generator)
    return None


def apply_attack(attack_fn, images, labels, generator=None):
    """The reference's apply_attack: the adversarial images only."""
    adv, _ = attack_fn(images, labels, generator)
    return adv


__all__ = ["ATTACKS", "apgd_ce", "apply_attack", "bim", "cw_l2", "fgsm", "l2_bim", "l2pgd",
           "linf_bim", "make_attack", "pgd"]
