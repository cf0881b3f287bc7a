"""The port's reference loader and exporters against ladine_tpu's, on the CPU.

One flax tree (guidance and three members), two routes that must agree bit
for bit: the JAX package's exporters write reference ``.pth`` files
(``ladine_tpu/utils/torch_convert.py``) that the port's loader reads into
its modules' state dicts, against ``utils/convert.py``'s direct bridge; and
the port's exporters against the JAX package's, array for array, wrapper
and ``num_batches_tracked`` included. No tolerance anywhere: every step
copies, renames or transposes.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladine_tpu.models import ConditionalModel as JaxConditionalModel
from ladine_tpu.models import SEViTGuidance as JaxGuidance
from ladine_tpu.utils import torch_convert as jtc
from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance
from ladine_tpu_torch.utils import guidance_from_flax, members_from_flax
from ladine_tpu_torch.utils import torch_convert as tc
from torch_parity import jax_members

G = dict(num_classes=2, num_members=3, vit_depth=3, img_size=16, patch_size=8, embed_dim=16,
         num_heads=2, mlp_hidden_dims=(16, 8, 8))
M, D, FEAT, T = 3, 768, 8, 11


@pytest.fixture(scope="module")
def trees():
    gvars = jax.tree.map(np.asarray, jax.jit(JaxGuidance(**G).init)(jax.random.PRNGKey(0),
                                                                     jnp.zeros((1, 16, 16, 3))))
    jm = JaxConditionalModel(data_dim=D, feature_dim=FEAT, hidden_dim=FEAT, y_dim=2, n_steps=T)
    stacked = jax_members(jm, M, D)
    members = [jax.tree.map(lambda a, i=i: a[i], stacked) for i in range(M)]
    g = SEViTGuidance(**G, device="cpu")
    g.load_state_dict(guidance_from_flax(gvars))
    m = ConditionalModel(M, D, FEAT, FEAT, 2, T, device="cpu")
    m.load_state_dict(members_from_flax(stacked))
    return dict(gvars=gvars, stacked=stacked, members=members, g=g, m=m)


def _assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        w = want[k] if isinstance(want[k], torch.Tensor) else torch.from_numpy(np.asarray(want[k]))
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k


def test_jax_exported_files_load_into_the_port_bit_for_bit(trees, tmp_path):
    params = trees["gvars"]["params"]
    vit_pth = str(tmp_path / "vit.pth")
    jtc.save_torch_state_dict(jtc.export_vit(params["vit"], depth=3), vit_pth)
    mlp_pths = []
    for i in range(3):
        mlp_pths.append(str(tmp_path / f"block_{i}.pth"))
        jtc.save_torch_state_dict(jtc.export_mapping_mlp(params[f"mlp{i}"]), mlp_pths[-1])
    member_pths = []
    for i, v in enumerate(trees["members"]):
        member_pths.append(str(tmp_path / f"diffu{i}.pth"))
        jtc.save_torch_state_dict(jtc.export_conditional_model(v), member_pths[-1],
                                  wrapper_key="noise_estimator", epoch=i)

    g_sd = tc.guidance_from_reference(tc.load_torch_state_dict(vit_pth),
                                      [tc.load_torch_state_dict(p) for p in mlp_pths])
    _assert_bit_equal(g_sd, guidance_from_flax(trees["gvars"]))
    m_sd = tc.members_from_reference([tc.load_torch_state_dict(p) for p in member_pths])
    _assert_bit_equal(m_sd, members_from_flax(trees["stacked"]))
    # and they load into the modules (strict: every key, every shape)
    SEViTGuidance(**G, device="cpu").load_state_dict(g_sd)
    ConditionalModel(M, D, FEAT, FEAT, 2, T, device="cpu").load_state_dict(m_sd)


@pytest.mark.parametrize("part", ["vit", "mlp0", "mlp2", "member0", "member2"])
def test_port_exporters_equal_the_jax_exporters(trees, part):
    params = trees["gvars"]["params"]
    if part == "vit":
        got, want = tc.export_vit(trees["g"]), jtc.export_vit(params["vit"], depth=3)
        _assert_bit_equal(tc.export_vit(trees["g"].vit), want)
    elif part.startswith("mlp"):
        i = int(part[3:])
        got, want = tc.export_mapping_mlp(trees["g"], i), jtc.export_mapping_mlp(params[f"mlp{i}"])
        _assert_bit_equal(tc.export_mapping_mlp(trees["g"].mlps[i]), want)
    else:
        i = int(part[6:])
        got = tc.export_conditional_model(trees["m"], i)
        want = jtc.export_conditional_model(trees["members"][i])
        assert got["norm.num_batches_tracked"].dtype == torch.int64
    _assert_bit_equal(got, want)


def test_saved_files_equal_the_jax_package_s(trees, tmp_path):
    """The .pth files, wrapper and all: {'noise_estimator': sd, 'optimizer':
    {}, 'epoch': E}, float32 tensors and the int64 BatchNorm counters."""
    ours, theirs = str(tmp_path / "ours.pth"), str(tmp_path / "theirs.pth")
    tc.save_torch_state_dict(tc.export_conditional_model(trees["m"], 1), ours,
                             wrapper_key="noise_estimator", epoch=7)
    jtc.save_torch_state_dict(jtc.export_conditional_model(trees["members"][1]), theirs,
                              wrapper_key="noise_estimator", epoch=7)
    a = torch.load(ours, weights_only=True)
    b = torch.load(theirs, weights_only=True)
    assert sorted(a) == sorted(b) == ["epoch", "noise_estimator", "optimizer"]
    assert a["epoch"] == b["epoch"] == 7 and a["optimizer"] == b["optimizer"] == {}
    # one known difference: the JAX package's file holds each 0-d
    # num_batches_tracked as shape (1,) (np.ascontiguousarray makes a 0-d
    # array 1-d); the port writes it 0-d, as torch's BatchNorm1d keeps it,
    # and torch's load_state_dict takes either
    counters = [k for k in b["noise_estimator"] if k.endswith("num_batches_tracked")]
    assert len(counters) == 6
    for k in counters:
        assert a["noise_estimator"][k].shape == () and b["noise_estimator"][k].shape == (1,)
        b["noise_estimator"][k] = b["noise_estimator"][k].reshape(())
    _assert_bit_equal(a["noise_estimator"], b["noise_estimator"])
    tc.save_torch_state_dict(tc.export_vit(trees["g"]), ours)
    jtc.save_torch_state_dict(jtc.export_vit(trees["gvars"]["params"]["vit"], depth=3), theirs)
    _assert_bit_equal(torch.load(ours, weights_only=True), torch.load(theirs, weights_only=True))


def test_bf16_round_trip_through_float32_files_is_exact(trees, tmp_path):
    """bf16 modules -> float32 reference state dicts -> fresh bf16 modules,
    tensor for tensor (what the card's smoke run does at full width)."""
    g = SEViTGuidance(**G, device="cpu", dtype=torch.bfloat16)
    g.load_state_dict(trees["g"].state_dict())
    m = ConditionalModel(M, D, FEAT, FEAT, 2, T, device="cpu", dtype=torch.bfloat16)
    m.load_state_dict(trees["m"].state_dict())
    assert tc.export_conditional_model(m, 0)["lin2.lin.weight"].dtype == torch.float32
    g2 = SEViTGuidance(**G, device="cpu", dtype=torch.bfloat16)
    g2.load_state_dict(tc.guidance_from_reference(tc.export_vit(g),
                                                  [tc.export_mapping_mlp(g, i) for i in range(3)]))
    m2 = ConditionalModel(M, D, FEAT, FEAT, 2, T, device="cpu", dtype=torch.bfloat16)
    path = str(tmp_path / "diffu.pth")
    sds = []
    for i in range(M):
        tc.save_torch_state_dict(tc.export_conditional_model(m, i), path, wrapper_key="noise_estimator")
        sds.append(tc.load_torch_state_dict(path))
    m2.load_state_dict(tc.members_from_reference(sds))
    _assert_bit_equal(g2.state_dict(), g.state_dict())
    _assert_bit_equal(m2.state_dict(), m.state_dict())


def test_loader_reads_whole_module_pickles_and_picks_keys(tmp_path):
    net = torch.nn.Sequential(torch.nn.Linear(3, 2))
    path = str(tmp_path / "module.pth")
    torch.save(net, path)
    _assert_bit_equal(tc.load_torch_state_dict(path), net.state_dict())
    both = str(tmp_path / "both.pth")
    torch.save({"noise_estimator": {"a": torch.ones(2)}, "other": net, "epoch": 1}, both)
    _assert_bit_equal(tc.load_torch_state_dict(both), {"a": torch.ones(2)})
    _assert_bit_equal(tc.load_torch_state_dict(both, key="other"), net.state_dict())


def test_loader_names_the_module_a_pickle_cannot_import(tmp_path):
    """A whole-module pickle of a class that does not import here (timm's
    ViT, the reference's Classifier) fails with the module's name."""
    src = tmp_path / "mapping_models_probe.py"
    src.write_text("import torch\n\nclass Classifier(torch.nn.Module):\n"
                   "    def __init__(self):\n        super().__init__()\n"
                   "        self.linear1 = torch.nn.Linear(4, 2)\n")
    sys.path.insert(0, str(tmp_path))
    try:
        import mapping_models_probe

        path = str(tmp_path / "block_0.pth")
        torch.save(mapping_models_probe.Classifier(), path)
        assert sorted(tc.load_torch_state_dict(path)) == ["linear1.bias", "linear1.weight"]
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("mapping_models_probe", None)
    os.remove(src)
    with pytest.raises(ModuleNotFoundError, match="mapping_models_probe"):
        tc.load_torch_state_dict(path)
