"""Serving API: the nested-ensemble predictor.

Counterpart of ``ladine_tpu/infer/serve.py::Predictor``:

    predictor = Predictor.from_preset("parity", guidance=g, model=m, sched=s)
    out = predictor.predict(images)          # NHWC float32 [0, 1]
    out["probs"], out["majority_vote"], out["piw"], out["mc_variance"]

One ``predict`` runs the guidance heads, the member encoders and the
reverse chain of every member x MC trial x image on the card, then
aggregates the samples into the four numpy outputs. The ``serving`` and
``fast`` presets run the eps matmuls in int8 (``use_int8``), and ``fast``
the encoders' and mapping heads' first layers too (``use_int8_encode``);
``use_int8_pallas`` (with ``pallas_fuse_ends``) runs the int8 eps through
the K4 (K5) kernels. The int8 weights are quantized once, at construction,
beside the float weights, which stay as they are.

``save``/``load`` keep a predictor as a directory (``utils/checkpoint.py``):
the float weights, the schedule and the settings, with the JAX package's
``ladine_meta.json``. ``export_serving`` is not ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import itertools
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from ladine_tpu_torch.device import resolve_device
from ladine_tpu_torch.infer.engine import nested_ensemble_sample
from ladine_tpu_torch.kernels.int8 import (
    int8_mapping_heads,
    quantize_encoder,
    quantize_mapping_heads,
    quantize_member,
)
from ladine_tpu_torch.metrics.classification import convert_to_prob, majority_vote
from ladine_tpu_torch.models.conditional import ConditionalModel
from ladine_tpu_torch.models.guidance import SEViTGuidance
from ladine_tpu_torch.ops.diffusion import ddim_timesteps
from ladine_tpu_torch.ops.schedules import DiffusionSchedule
from ladine_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

# The JAX package's named operating points: "parity" is the full ancestral
# chain in float; "serving" a 50-step strided sampler with int8 eps matmuls;
# "fast" a 10-step one with int8 eps, encoders and mapping heads.
PRESETS = {
    "parity": dict(ddim_steps=0, use_int8=False, use_int8_encode=False),
    "serving": dict(ddim_steps=50, ddim_eta=1.0, skip_type="uniform",
                    use_int8=True, use_int8_encode=False),
    "fast": dict(ddim_steps=10, ddim_eta=1.0, skip_type="uniform",
                 use_int8=True, use_int8_encode=True),
}


def call_seed(seed: int, counter: int) -> int:
    """The generator seed of one ``predict`` call: ``seed`` and the call
    counter mixed into 64 bits (``numpy.random.SeedSequence``), for any
    non-negative ints. The JAX package folds the counter into
    ``PRNGKey(seed)``; the draws differ, the property is the same: distinct
    (seed, counter) pairs give distinct streams."""
    return int(np.random.SeedSequence([int(seed), int(counter)]).generate_state(1, np.uint64)[0])


@dataclasses.dataclass
class Predictor:
    guidance: SEViTGuidance
    model: ConditionalModel
    sched: DiffusionSchedule
    temperature: float = 0.1737
    mc_trials: int = 20
    ddim_steps: int = 50  # strided sampler steps (0 = full ancestral chain)
    ddim_eta: float = 1.0
    skip_type: str = "uniform"  # strided timestep spacing: uniform | quad
    noise_prior: bool = False  # zero prior mean at T (reference --noise_prior)
    use_int8: bool = False
    use_int8_encode: bool = False  # int8 enc_lin1, and mapping-head linear1
    # int8 eps through the K4 kernel (kernels/int8_linear.py); wins over
    # use_int8. With pallas_fuse_ends the two K5 kernels
    # (kernels/int8_eps_fused.py).
    use_int8_pallas: bool = False
    pallas_fuse_ends: bool = False
    seed: int = 0
    # which guidance heads condition the stacked members; None = heads
    # 0..n_stacked-1
    head_indices: Optional[tuple] = None
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.guidance.to(self.device)
        self.model.to(self.device)
        self.sched = self.sched.to(self.device)
        self._tau = (
            ddim_timesteps(self.sched.num_timesteps, self.ddim_steps, self.skip_type).tolist()
            if self.ddim_steps
            else None
        )
        n_stacked = self.model.members
        idx = tuple(
            int(i) for i in (
                self.head_indices if self.head_indices is not None else range(n_stacked)
            )
        )
        if len(idx) != n_stacked:
            raise ValueError(
                f"head_indices {self.head_indices} must match the {n_stacked} stacked members"
            )
        n_heads = self.guidance.num_members + 1
        if any(not 0 <= i < n_heads for i in idx):
            raise ValueError(
                f"head_indices {self.head_indices} out of range: the guidance "
                f"has {n_heads} heads (0..{n_heads - 1})"
            )
        self._idx = idx
        # The resident int8 weights, quantized once here (member by member,
        # never in place). The mapping heads' linear1 goes int8 only when
        # every conditioning head is a mapping head.
        self._qmember = quantize_member(self.model) if self.use_int8 or self.use_int8_pallas else None
        self._qenc = quantize_encoder(self.model) if self.use_int8_encode else None
        int8_heads = self.use_int8_encode and all(i < self.guidance.num_members for i in idx)
        self._qheads = quantize_mapping_heads(self.guidance, idx) if int8_heads else None
        # itertools.count is atomic under the GIL: concurrent predict() calls
        # in a threaded server never share a seed
        self._counter = itertools.count()

    @classmethod
    def from_preset(cls, preset: str, **kwargs) -> "Predictor":
        """A predictor at a named operating point; explicit ``kwargs`` win."""
        if preset not in PRESETS:
            raise ValueError(f"unknown preset {preset!r}; available: {sorted(PRESETS)}")
        return cls(**{**PRESETS[preset], **kwargs})

    @torch.inference_mode()
    def predict(
        self,
        images,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Dict[str, np.ndarray]:
        """images: (B, H, W, 3) float32 in [0, 1]. Returns numpy outputs.

        Without a ``generator``, each call seeds a fresh one from ``seed``
        and a call counter. ``noise`` injects the sampler's draws (see
        ``infer.engine.nested_ensemble_sample``)."""
        s = self.guidance.img_size
        if images.ndim != 4 or tuple(images.shape[1:]) != (s, s, 3):
            raise ValueError(
                f"predict expects images of shape (B, {s}, {s}, 3); got {tuple(images.shape)}"
            )
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(call_seed(self.seed, next(self._counter)))
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        if self._qheads is not None:
            taps = self.guidance.taps_subset(x, self._idx)
            heads = int8_mapping_heads(self.guidance, taps, self._idx, self._qheads)
        else:
            heads = self.guidance.heads_subset(x, self._idx)
        y0_hat = torch.softmax(heads.float(), dim=-1)
        x_flat = x.reshape(x.shape[0], -1)  # NHWC, channel-last
        samples = nested_ensemble_sample(
            self.model, x_flat, y0_hat, self.sched, mc_trials=self.mc_trials,
            tau=self._tau, eta=self.ddim_eta, noise_prior=self.noise_prior,
            generator=generator, noise=noise,
            use_int8_eps=self.use_int8 and not self.use_int8_pallas,
            use_int8_encode=self.use_int8_encode, use_int8_pallas=self.use_int8_pallas,
            pallas_fuse_ends=self.pallas_fuse_ends, qmember=self._qmember, qenc=self._qenc,
        )
        m, k, b, c = samples.shape
        flat = samples.reshape(m * k, b, c)
        probs = convert_to_prob(flat, self.temperature).mean(dim=0)
        mv = majority_vote(flat)
        q = torch.tensor([0.025, 0.975], dtype=flat.dtype, device=flat.device)
        lo, hi = torch.quantile(flat, q, dim=0)  # linear interpolation, as jnp
        piw = (hi - lo).gather(1, mv[:, None])[:, 0]
        var = flat.var(dim=0, correction=1).gather(1, mv[:, None])[:, 0]
        return {
            "probs": probs.cpu().numpy(),
            "majority_vote": mv.cpu().numpy(),
            "piw": piw.cpu().numpy(),
            "mc_variance": var.cpu().numpy(),
        }

    # ------------------------------------------------------------ artifact io

    def save(self, path: str) -> None:
        """Write the predictor as a directory: the float weights of the
        guidance and of the stacked members (never the resident int8
        copies), the schedule tensors verbatim, and ``ladine_meta.json``
        with the JAX package's keys and values (settings, ``head_indices``,
        the compute dtype and the geometry). ``seed`` is not saved, as in
        the JAX package."""
        g, m = self.guidance, self.model
        meta = {
            "kind": "predictor",
            "temperature": self.temperature,
            "mc_trials": self.mc_trials,
            "ddim_steps": self.ddim_steps,
            "ddim_eta": self.ddim_eta,
            "skip_type": self.skip_type,
            "noise_prior": self.noise_prior,
            "use_int8": self.use_int8,
            "use_int8_encode": self.use_int8_encode,
            "use_int8_pallas": self.use_int8_pallas,
            "pallas_fuse_ends": self.pallas_fuse_ends,
            "head_indices": [int(i) for i in self.head_indices] if self.head_indices else None,
            "dtype": _dtype_name(m.lin2.linear.weight.dtype),
            "guidance": {
                "num_classes": g.num_classes,
                "num_members": g.num_members,
                "vit_depth": g.vit_depth,
                "img_size": g.img_size,
                "patch_size": g.patch_size,
                "embed_dim": g.embed_dim,
                "num_heads": g.num_heads,
                "mlp_hidden_dims": list(g.mlp_hidden_dims),
                "dtype": _dtype_name(g.vit.patch_proj.weight.dtype),
            },
            "model": {
                "data_dim": m.data_dim,
                "feature_dim": m.feature_dim,
                "hidden_dim": m.hidden_dim,
                "y_dim": m.y_dim,
                "n_steps": m.n_steps,
                "arch": "linear",
                "guidance": True,
            },
        }
        tree = {"guidance": g.state_dict(), "members": m.state_dict(), "schedule": self.sched._asdict()}
        save_checkpoint(path, tree, meta)

    @classmethod
    def load(cls, path: str, preset: Optional[str] = None, dtype: Any = "artifact",
             device="cuda", **overrides) -> "Predictor":
        """A predictor saved by :meth:`save`, on ``device``. ``preset`` applies
        a named operating point (:data:`PRESETS`) over the saved settings;
        ``overrides`` win over both. ``dtype``: the compute dtype of the
        rebuilt modules; ``"artifact"`` restores the saved one (an artifact
        without it loads as float32), or pass ``"bfloat16"``/``"float32"``.

        The port cannot read the JAX package's orbax artifacts (it imports no
        orbax). From the JAX package, weights come in through the reference
        ``.pth`` files its ``cli/convert.py --export`` writes
        (``utils/torch_convert.py``), or from flax trees in memory
        (``utils/convert.py``); build the ``Predictor`` from those modules
        and ``save`` it."""
        if preset is not None and preset not in PRESETS:
            raise ValueError(f"unknown preset {preset!r}; available: {sorted(PRESETS)}")
        dev = resolve_device(device)
        tree, meta = load_checkpoint(path, map_location=dev)
        if "guidance" not in meta:
            raise ValueError(f"{path} is not a predictor artifact (kind: {meta.get('kind', 'unknown')})")
        g = meta["guidance"]
        if dtype == "artifact":
            g_dtype = _dtype_from_name(g.get("dtype", meta.get("dtype")))
            m_dtype = _dtype_from_name(meta.get("dtype"))
        else:
            g_dtype = m_dtype = _dtype_from_name(dtype)
        # built on the meta device and given the loaded tensors: no second copy
        guidance = SEViTGuidance(
            num_classes=g["num_classes"], num_members=g["num_members"], vit_depth=g["vit_depth"],
            img_size=g["img_size"], patch_size=g["patch_size"], embed_dim=g["embed_dim"],
            num_heads=g["num_heads"], mlp_hidden_dims=tuple(g["mlp_hidden_dims"]),
            device="meta", dtype=g_dtype,
        )
        _assign(guidance, tree["guidance"])
        m = meta["model"]
        if m.get("arch", "linear") != "linear" or not m.get("guidance", True):
            raise NotImplementedError(f"the port serves arch 'linear' with guidance; {path} has {m}")
        model = ConditionalModel(
            tree["members"]["enc_lin1.weight"].shape[0], data_dim=m["data_dim"],
            feature_dim=m["feature_dim"], hidden_dim=m["hidden_dim"], y_dim=m["y_dim"],
            n_steps=m["n_steps"], device="meta", dtype=m_dtype,
        )
        _assign(model, tree["members"])
        sched = DiffusionSchedule(**tree["schedule"])
        if ("ddim_eta" not in meta and "ddim_eta" not in overrides
                and (preset is None or "ddim_eta" not in PRESETS[preset])):
            # an artifact saved before ddim_eta existed ran (and was
            # calibrated at) eta 0; a caller or preset that sets eta chose it
            warnings.warn(
                f"predictor artifact {path} predates ddim_eta; defaulting to "
                "the legacy eta=0.0 it was saved under",
                stacklevel=2,
            )
        hi = meta.get("head_indices")
        kwargs = dict(
            temperature=meta["temperature"], mc_trials=meta["mc_trials"],
            ddim_steps=meta["ddim_steps"], ddim_eta=meta.get("ddim_eta", 0.0),
            skip_type=meta.get("skip_type", "uniform"), noise_prior=meta.get("noise_prior", False),
            use_int8=meta["use_int8"], use_int8_encode=meta.get("use_int8_encode", False),
            use_int8_pallas=meta.get("use_int8_pallas", False),
            pallas_fuse_ends=meta.get("pallas_fuse_ends", False),
            head_indices=tuple(hi) if hi else None,
        )
        if preset is not None:
            kwargs.update(PRESETS[preset])
        kwargs.update(overrides)
        return cls(guidance=guidance, model=model, sched=sched, device=dev, **kwargs)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _dtype_from_name(name) -> torch.dtype:
    """A saved dtype name (None: float32, the JAX package's default) or a
    torch dtype -> the torch dtype."""
    if name is None:
        return torch.float32
    if isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def _assign(module: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Load ``state`` into a module built on the meta device, each tensor
    cast to the dtype the module holds it in (a no-op where they agree)."""
    own = module.state_dict()
    module.load_state_dict({k: v.to(own[k].dtype) if k in own else v for k, v in state.items()},
                           assign=True)
