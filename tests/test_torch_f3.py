"""F3: a float32 artifact served in bfloat16 is quantized from its float32
tensors, as the JAX package quantizes its float32 parameters.

``Predictor.load(path, dtype="bfloat16")`` rebuilds the modules in bf16.
The resident int8 forms (lin2/lin3 of every member at ``serving`` and
``fast``; enc_lin1 and the mapping heads' linear1 at ``fast``) must still
come from the artifact's float32 weights: their codes, scales and colsums
are held bit for bit against ``ladine_tpu/kernels/int8.py``'s
``quantize_member``, ``quantize_encoder`` and ``quantize_mapping_heads`` on
those weights. The weights are random float32 values, not bf16-representable
(checked), so quantizing bf16-rounded copies gives other codes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladine_tpu.kernels import int8 as jint8
from ladine_tpu_torch.infer import Predictor
from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance, init_random_
from ladine_tpu_torch.ops import DiffusionSchedule
from ladine_tpu_torch.utils.convert import guidance_to_flax, members_to_flax

G = dict(num_classes=2, num_members=3, vit_depth=3, img_size=16, patch_size=8, embed_dim=16,
         num_heads=2, mlp_hidden_dims=(64, 8, 8))
M, FEAT = 3, 64


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    gen = torch.Generator().manual_seed(11)
    g = init_random_(SEViTGuidance(**G, device="cpu"), gen)
    m = init_random_(ConditionalModel(M, 768, FEAT, FEAT, 2, 21, device="cpu"), gen)
    path = str(tmp_path_factory.mktemp("f3") / "fp32")
    Predictor(guidance=g, model=m, sched=DiffusionSchedule.create("linear", 20, device="cpu"),
              mc_trials=2, device="cpu").save(path)
    return path, g.state_dict(), m.state_dict()


def _differ(got: torch.Tensor, want) -> int:
    return int((got.numpy() != np.asarray(want)).sum())


def test_artifact_is_not_bf16_representable(artifact):
    _, _, members = artifact
    w = members["lin2.linear.weight"]
    assert not torch.equal(w, w.bfloat16().float())


@pytest.mark.parametrize("preset", ["serving", "fast"])
def test_bf16_load_quantizes_the_fp32_tensors(artifact, preset):
    path, guidance, members = artifact
    p = Predictor.load(path, preset=preset, dtype="bfloat16", device="cpu")
    assert p.model.lin2.linear.weight.dtype == torch.bfloat16  # the modules are bf16
    stacked = members_to_flax(members)
    differ = {}
    for i in range(M):
        one = jax.tree.map(lambda a: jnp.asarray(a[i]), stacked)
        want = jint8.quantize_member(one)["int8"]
        for name in ("lin2", "lin3"):
            for part, got, ref in zip(("codes", "scale", "colsum"), p._qmember[name], want[name]):
                differ[f"member {i} {name} {part}"] = _differ(got[i], ref)
        if preset == "fast":
            enc = jint8.quantize_encoder(one)
            differ[f"member {i} enc_lin1 codes"] = _differ(
                p._qenc[0][i], enc["params"]["enc_lin1"]["Dense_0"]["kernel"])
            differ[f"member {i} enc_lin1 scale"] = _differ(p._qenc[1][i], enc["int8_enc"]["scale"])
    if preset == "fast":
        gvars = guidance_to_flax(guidance, G["vit_depth"], G["num_members"])
        want = jint8.quantize_mapping_heads(gvars, range(M))
        for i in range(M):
            differ[f"head {i} codes"] = _differ(p._qheads[i][0],
                                                want["params"][f"mlp{i}"]["linear1"]["Dense_0"]["kernel"])
            differ[f"head {i} scale"] = _differ(p._qheads[i][1], want["int8_mlp_scale"][f"mlp{i}"])
    bad = {k: v for k, v in differ.items() if v}
    assert not bad, f"{sum(bad.values())} int8 values differ from the JAX package's: {bad}"
