"""Faults planted under the timed path, to show that the judge sees them:
each name gives the (owner, attribute, replacement) patches that break one
layer of the program. The CPU tests plant them with ``monkeypatch`` and
``portbench.control --fault`` on the card; the benchmark's own runs never
import this file.

* ``step_returns_its_state``: the sampler's step leaves y as it was;
* ``half_the_samples_left_out``: the aggregation reads half the samples;
* ``an_answer_altered``: the MC variance 2 % off where it is produced;
* ``rows_scattered_to_the_wrong_caller``: each row's outputs go to the next;
* ``a_wrong_tap``: every mapping head reads the ViT block of its neighbour;
* ``guidance_heads_swapped``: each member is conditioned on the y_hat of its
  neighbour's guidance head;
* ``an_encoder_activation_left_out``: the encoders skip their first
  softplus;
* ``probs_classes_swapped``: the tempered probabilities of the classes
  rolled by one;
* ``votes_flipped``: the majority vote names the next class.

``PROBES`` are faults read on the card but required of no test:
``an_encoder_reading_channels_first``, the member encoders reading the flat
image channels-first where the port flattens channel-last, shows how much
of the encoders' image dependence the judge can see. With random weights
little: two softplus layers of positive mean leave the features nearly the
same for every image (PERF.md).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Tuple

import numpy as np

Patch = Tuple[object, str, Callable]


def _samplers() -> List[Patch]:
    import ladine_tpu_torch.infer.engine as engine
    import ladine_tpu_torch.ops.diffusion as diffusion

    def unchanged_ancestral(y, eps, y_T_mean, coeffs, z):
        return y

    def unchanged_ddim(eps_fn, y_T_mean, sched, generator, tau, eta=0.0, noise=None, table=None):
        y = noise[0] + y_T_mean
        return diffusion.p_sample_final(y, eps_fn(y, int(tau[0])), y_T_mean, sched)

    return [(diffusion, "p_sample_step", unchanged_ancestral), (engine, "ddim_sample_loop", unchanged_ddim)]


def _aggregate(change: Callable) -> List[Patch]:
    import ladine_tpu_torch.infer.program as program

    aggregate = program.aggregate
    return [(program, "aggregate", lambda samples, temperature: change(aggregate, samples, temperature))]


def _half(aggregate, samples, temperature):
    return aggregate(samples[:, : samples.shape[1] // 2], temperature)


def _variance(aggregate, samples, temperature):
    probs, mv, piw, var = aggregate(samples, temperature)
    return probs, mv, piw, var * 1.02


def _swapped(aggregate, samples, temperature):
    probs, mv, piw, var = aggregate(samples, temperature)
    return probs.flip(-1), mv, piw, var


def _rows_rolled() -> List[Patch]:
    import ladine_tpu_torch.infer.serve as serve

    predict = serve.Predictor.predict

    def rolled(self, images, generator=None, noise=None):
        out = predict(self, images, generator, noise)
        return {k: np.roll(v, 1, axis=0) for k, v in out.items()}

    return [(serve.Predictor, "predict", rolled)]


def _wrong_tap() -> List[Patch]:
    from ladine_tpu_torch.models.vit import ViT

    taps = ViT._taps

    def neighbours(self, patches, depths):
        out = taps(self, patches, depths)
        return out[1:] + out[:1]

    return [(ViT, "_taps", neighbours)]


def _heads_swapped() -> List[Patch]:
    from ladine_tpu_torch.models.guidance import SEViTGuidance

    heads = SEViTGuidance.heads_subset
    return [(SEViTGuidance, "heads_subset", lambda self, x, indices: heads(self, x, indices).roll(1, dims=0))]


def _channels_first() -> List[Patch]:
    from ladine_tpu_torch.models.conditional import ConditionalModel

    encode = ConditionalModel.encode

    def channels_first(self, x):
        b = x.shape[0]
        return encode(self, x.reshape(b, -1, 3).transpose(1, 2).reshape(b, -1))

    return [(ConditionalModel, "encode", channels_first)]


def _activation_left_out() -> List[Patch]:
    import torch.nn.functional as F

    from ladine_tpu_torch.models.conditional import ConditionalModel

    def encode(self, x):
        h = self.enc_bn1(self.enc_lin1(x))
        h = F.softplus(self.enc_bn2(self.enc_lin2(h)))
        return self.norm(self.enc_lin3(h))

    return [(ConditionalModel, "encode", encode)]


def _votes_flipped(aggregate, samples, temperature):
    probs, mv, piw, var = aggregate(samples, temperature)
    return probs, (mv + 1) % samples.shape[-1], piw, var


FAULTS: Dict[str, Callable[[], List[Patch]]] = {
    "step_returns_its_state": _samplers,
    "half_the_samples_left_out": lambda: _aggregate(_half),
    "an_answer_altered": lambda: _aggregate(_variance),
    "rows_scattered_to_the_wrong_caller": _rows_rolled,
    "a_wrong_tap": _wrong_tap,
    "guidance_heads_swapped": _heads_swapped,
    "an_encoder_activation_left_out": _activation_left_out,
    "probs_classes_swapped": lambda: _aggregate(_swapped),
    "votes_flipped": lambda: _aggregate(_votes_flipped),
}


PROBES: Dict[str, Callable[[], List[Patch]]] = {
    "an_encoder_reading_channels_first": _channels_first,
}


def patches(name: str) -> List[Patch]:
    return {**FAULTS, **PROBES}[name]()


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` in place while the block runs."""
    saved = []
    try:
        for owner, attr, fn in patches(name):
            saved.append((owner, attr, owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)))
            setattr(owner, attr, fn)
        yield
    finally:
        for owner, attr, old in reversed(saved):
            setattr(owner, attr, old)
