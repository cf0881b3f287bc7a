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

``predict`` checks the images, draws the sampler's noise and runs the
serving program (``infer/program.py``), a function of tensors only. On the
card the first call at a batch size captures that program as a CUDA graph,
and every call replays it (``infer/graphs.py``): the port's counterpart of
the JAX package's one compiled program per batch shape.

``save``/``load`` keep a predictor as a directory (``utils/checkpoint.py``):
the float weights, the schedule and the settings, with the JAX package's
``ladine_meta.json``. ``export_serving`` writes an AOT bundle that
``ExportedPredictor`` serves without model code (``infer/exported.py``).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from ladine_tpu_torch.device import resolve_device
from ladine_tpu_torch.infer.exported import (
    WEIGHTS,
    call_seed,
    program_path,
    request_images,
    request_noise,
    run_request,
)
from ladine_tpu_torch.infer.graphs import GraphCache
from ladine_tpu_torch.infer.program import ServingProgram, WeightsAsInputs
from ladine_tpu_torch.kernels.int8 import quantize_encoder, quantize_mapping_heads, quantize_member
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
# what an exported program may hold of its own (the few constants the
# program makes); a weight read from outside the run weights would be more
_MAX_PROGRAM_BYTES = 1 << 20


def _head_indices(head_indices, n_stacked: int, n_heads: int) -> tuple:
    """The guidance heads that condition the stacked members, checked."""
    idx = tuple(int(i) for i in (head_indices if head_indices is not None else range(n_stacked)))
    if len(idx) != n_stacked:
        raise ValueError(f"head_indices {head_indices} must match the {n_stacked} stacked members")
    if any(not 0 <= i < n_heads for i in idx):
        raise ValueError(f"head_indices {head_indices} out of range: the guidance has {n_heads} heads "
                         f"(0..{n_heads - 1})")
    return idx


def _int8_forms(guidance, members, idx, num_members: int, use_int8: bool, use_int8_pallas: bool,
                use_int8_encode: bool, arch: str):
    """The resident int8 forms the settings call for, quantized from
    ``guidance`` and ``members`` (the modules, or their tensors by name):
    (member lin2/lin3, enc_lin1, mapping heads' linear1), None where not
    used. enc_lin1 goes int8 only for arch ``linear`` (the conv archs keep a
    float encoder, as the JAX Predictor does): the program's int8 encode
    runs where this returns it. The mapping heads go int8 only when every
    conditioning head is a mapping head."""
    qmember = quantize_member(members) if use_int8 or use_int8_pallas else None
    qenc = quantize_encoder(members) if use_int8_encode and arch == "linear" else None
    int8_heads = use_int8_encode and all(i < num_members for i in idx)
    return qmember, qenc, quantize_mapping_heads(guidance, idx) if int8_heads else None


@dataclasses.dataclass
class Predictor:
    """A predictor built from modules quantizes its int8 forms from what the
    modules hold, in their dtype. :meth:`load` quantizes them from the
    artifact's own tensors before any cast to a narrower compute dtype, as
    the JAX package quantizes its float32 parameters."""

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
    # the int8 forms load() quantized from the artifact (_int8_forms); None:
    # quantize the modules here
    _int8: Optional[tuple] = dataclasses.field(default=None, repr=False)

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
        self._idx = _head_indices(self.head_indices, self.model.members, self.guidance.num_members + 1)
        # The resident int8 weights, quantized once (member by member, never
        # in place).
        forms = self._int8 if self._int8 is not None else _int8_forms(
            self.guidance, self.model, self._idx, self.guidance.num_members,
            self.use_int8, self.use_int8_pallas, self.use_int8_encode, self.model.arch)
        self._int8 = None
        self._qmember, self._qenc, self._qheads = forms
        self._program = ServingProgram(
            self.guidance, self.model, self.sched, self._idx, temperature=self.temperature,
            mc_trials=self.mc_trials, tau=self._tau, eta=self.ddim_eta, noise_prior=self.noise_prior,
            use_int8_eps=self.use_int8 and not self.use_int8_pallas,
            use_int8_pallas=self.use_int8_pallas, pallas_fuse_ends=self.pallas_fuse_ends,
            qmember=self._qmember, qenc=self._qenc, qheads=self._qheads,
        )
        self._graphs = GraphCache(self._program, self.device) if self.device.type == "cuda" else None
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
        and a call counter; all the sampler's draws are one ``torch.randn``
        from it. ``noise`` injects those draws instead, (n_draws, M,
        mc_trials, B, y_dim) (see ``infer.engine.nested_ensemble_sample``).
        On the card the first call at a batch size captures the serving
        program as a CUDA graph; every call replays it."""
        x = request_images(images, self.guidance.img_size)
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(call_seed(self.seed, next(self._counter)))
        z = request_noise(self._program.noise_shape(x.shape[0]), self.device, generator, noise)
        return run_request(self._program, self._graphs, self.device, x, z)

    def export_serving(self, path: str, batch_sizes=(70,)) -> Dict[int, float]:
        """AOT deployment bundle: the serving program exported with
        ``torch.export`` (one ``programs/serving_b{B}.pt2`` per batch size),
        the run weights once (``weights/``: the float weights and the
        resident int8 forms that replace theirs, as the JAX bundle carries
        its run trees) and the meta. The run weights are inputs of every
        program, so the programs carry no copy of them. Reload with
        ``ExportedPredictor.load``: serving then needs no model code and no
        tracing, and cannot diverge from the program that was validated.

        Fixed shapes by design; to sit behind a ``MicroBatcher`` pass
        ``batch_sizes=MicroBatcher.bucket_sizes(cap)``. Locked to the device
        type it is exported on, as the JAX bundle is platform-locked: export
        on the card you serve on. Returns the seconds of each export."""
        s = self.guidance.img_size
        weights = self._program.run_weights()
        wrapped = WeightsAsInputs(self._program)
        os.makedirs(os.path.dirname(program_path(path, 0)), exist_ok=True)
        seconds = {}
        with torch.no_grad():
            for b in batch_sizes:
                t0 = time.perf_counter()
                images = torch.zeros((int(b), s, s, 3), device=self.device)
                noise = torch.zeros(self._program.noise_shape(int(b)), device=self.device)
                ep = torch.export.export(wrapped, (weights, images, noise), strict=False)
                held = sum(t.numel() * t.element_size()
                           for t in (*ep.state_dict.values(), *ep.constants.values())
                           if isinstance(t, torch.Tensor))
                if held > _MAX_PROGRAM_BYTES:
                    raise RuntimeError(f"the exported program holds {held} bytes of tensors: it reads a "
                                       "weight that the run weights leave out")
                ep.example_inputs = None  # else saved with the program: a copy of every weight
                torch.export.save(ep, program_path(path, b))
                seconds[int(b)] = time.perf_counter() - t0
        n, m, k, _, c = self._program.noise_shape(1)
        save_checkpoint(os.path.join(path, WEIGHTS), weights, {
            "kind": "exported_predictor",
            "batch_sizes": [int(b) for b in batch_sizes],
            "img_size": int(s),
            "seed": int(self.seed),
            "settings": {
                "arch": self.model.arch,
                "guidance": self.model.guidance,
                "temperature": self.temperature,
                "mc_trials": self.mc_trials,
                "ddim_steps": self.ddim_steps,
                "ddim_eta": self.ddim_eta,
                "use_int8": self.use_int8,
                "use_int8_encode": self.use_int8_encode,
            },
            "noise_shape": [n, m, k, c],
            "torch_version": torch.__version__,
            "device_type": self.device.type,
        })
        return seconds

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
                "arch": m.arch,
                "guidance": m.guidance,
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
        m = meta["model"]
        model = ConditionalModel(
            tree["members"]["lin4.weight"].shape[0], data_dim=m["data_dim"],
            feature_dim=m["feature_dim"], hidden_dim=m["hidden_dim"], y_dim=m["y_dim"],
            n_steps=m["n_steps"], guidance=m.get("guidance", True), device="meta", dtype=m_dtype,
            arch=m.get("arch", "linear"),
        )
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
        # the int8 forms come from the artifact's own tensors, before _assign
        # casts them to the compute dtype (as the JAX package quantizes its
        # float32 parameters)
        idx = _head_indices(kwargs["head_indices"], model.members, guidance.num_members + 1)
        forms = _int8_forms(tree["guidance"], tree["members"], idx, guidance.num_members,
                            kwargs["use_int8"], kwargs["use_int8_pallas"], kwargs["use_int8_encode"], model.arch)
        _assign(guidance, tree.pop("guidance"))
        _assign(model, tree.pop("members"))
        return cls(guidance=guidance, model=model, sched=sched, device=dev, _int8=forms, **kwargs)


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
