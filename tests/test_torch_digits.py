"""The port's real-data entry points against the JAX repository's scripts,
on the CPU: the digits corpus (``examples/make_digits_corpus.py`` against
``scripts/make_digits_corpus.py`` and the committed gzipped tree), the plan
of steps of ``examples/run_digits.py`` against ``scripts/run_digits.py``
(both drivers run with their step runner replaced by a recorder that
writes each step's artifact), a tiny ``--fast`` run on a subset of the
corpus, the gate and the state dtypes of ``examples/lowmem_ab.py``, and
``examples/minimal_slice.py`` against ``examples/minimal_slice.py`` of the
JAX package on the same weights and draws (its printed values, rounded to
3 decimals, to 1.5e-3).
"""

import contextlib
import gzip
import importlib.util
import io
import json
import os
import runpy
import signal
import sys

import jax
import numpy as np
import pytest
import torch

from ladine_tpu.models import ConditionalModel as JaxConditionalModel
from ladine_tpu.models import SEViTGuidance as JaxGuidance
from ladine_tpu_torch.data.downloads import read_idx
from ladine_tpu_torch.examples import lowmem_ab, minimal_slice, run_digits
from ladine_tpu_torch.examples import make_digits_corpus as corpus
from ladine_tpu_torch.models import ConditionalModel
from ladine_tpu_torch.train import create_member_states, make_optimizer
from ladine_tpu_torch.utils import guidance_from_flax, members_from_flax, save_train_state
from torch_parity import jax_loop_noise, one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW = os.path.join(corpus.CORPUS, "MNIST", "raw")


def _load_script(name, path):
    """A script of the JAX repository as a module, with the signal handlers
    its imports install put back afterwards."""
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    sys.path.insert(0, os.path.dirname(path))
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(os.path.dirname(path))
        for s, h in handlers.items():
            signal.signal(s, h)
    return module


# ------------------------------------------------------------------ the corpus


def test_corpus_writer_equals_the_jax_script_and_the_committed_tree(tmp_path, monkeypatch):
    pytest.importorskip("sklearn", reason="the corpus is exported from scikit-learn's load_digits")
    monkeypatch.setattr(sys, "argv", ["make_digits_corpus.py", "--out", str(tmp_path / "jax")])
    with contextlib.redirect_stdout(io.StringIO()):
        runpy.run_path(os.path.join(REPO, "scripts", "make_digits_corpus.py"), run_name="__main__")
        assert corpus.main(["--out", str(tmp_path / "port")]) == 0
        assert corpus.main(["--out", str(tmp_path / "gz"), "--gzip"]) == 0
    for name in corpus.FILES:
        want = (tmp_path / "jax" / "MNIST" / "raw" / name).read_bytes()
        assert (tmp_path / "port" / "MNIST" / "raw" / name).read_bytes() == want, name
        with gzip.open(os.path.join(RAW, name + ".gz")) as f:
            assert f.read() == want, name
        with gzip.open(tmp_path / "gz" / "MNIST" / "raw" / (name + ".gz")) as f:
            assert f.read() == want, name


def test_committed_corpus_reads_as_the_digits_split():
    """1442 train and 355 test images of 8x8, every class in both, through
    the port's IDX reader (gzipped files)."""
    tr_x, tr_y = read_idx(os.path.join(RAW, "train-images-idx3-ubyte")), read_idx(
        os.path.join(RAW, "train-labels-idx1-ubyte"))
    te_x, te_y = read_idx(os.path.join(RAW, "t10k-images-idx3-ubyte")), read_idx(
        os.path.join(RAW, "t10k-labels-idx1-ubyte"))
    assert tr_x.shape == (1442, 8, 8) and te_x.shape == (355, 8, 8)
    assert set(tr_y.tolist()) == set(te_y.tolist()) == set(range(10))
    assert tr_x.max() == 255 and tr_x.min() == 0


# ------------------------------------------------------- the plan of run_digits


def _write_artifacts(module, argv, log_path):
    """What a completed step leaves behind, for the drivers' resume checks."""
    def value(flag):
        return argv[argv.index(flag) + 1]

    def meta(path, **kw):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "ladine_meta.json"), "w") as f:
            json.dump(kw, f)

    if module == "train_transformer":
        meta(os.path.join(value("--out"), "vit_MNIST"))
        with open(log_path, "a") as f:
            f.write(json.dumps({"mode": "train_transformer", "best_val_accuracy": 91.5}) + "\n")
    elif module == "train_mapping":
        k = int(value("--mlp_idx"))
        meta(os.path.join(value("--out"), "MNIST", "MLPs", f"block_{k}"), accuracy=90.0 + k)
    elif module == "main" and "--train" in argv:
        logs = os.path.join(value("--exp"), "logs", value("--doc"))
        meta(os.path.join(logs, f"diffu{value('--mlp_idx')}_ckpt_best_eph3_acc50.0000"))
        with open(os.path.join(logs, "train_complete.json"), "w") as f:
            json.dump({}, f)
    elif module == "main":
        logs = os.path.join(value("--exp"), "logs", value("--doc"))
        os.makedirs(logs, exist_ok=True)
        report = dict.fromkeys(run_digits.REPORT_KEYS, 1.0)
        report["calibrated_temperature"] = 0.25 if "--eval_ema" in argv else 0.125
        report["ece_vote_fraction_limit"] = 0.5
        with open(os.path.join(logs, "report.json"), "w") as f:
            json.dump(report, f)


def _normal(module, argv, work, config):
    return [module] + [a.replace(config, "CONFIG").replace(work, "W") for a in argv]


def test_run_digits_plans_the_jax_steps(tmp_path, monkeypatch):
    """The same stages, flags, seeds and epochs in the same order, with
    ``ladine_tpu.cli.X`` -> ``ladine_tpu_torch.cli.X`` and ``--cpu`` ->
    ``--device cpu``; the corpus is copied instead of exported; the port
    writes no evidence file unless asked, and its summary has the JAX keys."""
    jrd = _load_script("jax_run_digits", os.path.join(REPO, "scripts", "run_digits.py"))
    jax_work, port_work = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_cfg = os.path.join(str(tmp_path / "jaxrepo"), "configs", "digits.yml")
    jax_steps = []

    def jax_sh(args, log_path, env=None, done_check=None, **_):
        if args[1] == "-m":
            module, argv = args[2].rsplit(".", 1)[1], args[3:]
            assert args[2] == "ladine_tpu.cli." + module
            jax_steps.append(_normal(module, argv, jax_work, jax_cfg))
            _write_artifacts(module, argv, log_path)
        else:
            jax_steps.append([os.path.basename(args[1])] + args[2:])
        assert done_check is None or done_check()

    monkeypatch.setattr(jrd, "sh", jax_sh)
    monkeypatch.setattr(jrd, "REPO", str(tmp_path / "jaxrepo"))
    monkeypatch.setattr(sys, "argv", ["run_digits.py", "--work", jax_work, "--cpu"])
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        jrd.main()
    jax_out = json.loads(printed.getvalue().strip().splitlines()[-1])

    port_steps = []

    def port_step(module, argv, log_path, done=None):
        name = module.rsplit(".", 1)[1]
        assert module == "ladine_tpu_torch.cli." + name and argv[:2] == ["--device", "cpu"]
        port_steps.append(_normal(name, ["--cpu"] + argv[2:], port_work, run_digits.CONFIG))
        _write_artifacts(name, argv, log_path)
        assert done is None or done()
        return 1.0

    out = run_digits.run(port_work, "cpu", step=port_step)
    assert jax_steps[0] == ["make_digits_corpus.py", "--out", os.path.join(jax_work, "digits_root")]
    assert port_steps == jax_steps[1:]
    assert len(port_steps) == 1 + 5 + 5 + 6
    assert sorted(os.listdir(os.path.join(port_work, "digits_root", "MNIST", "raw"))) == sorted(
        n + ".gz" for n in corpus.FILES)
    assert {k: v for k, v in out.items() if k in jax_out} == jax_out
    assert out["stage_seconds"] == {"stage1a_vit": 1.0, "stage1b_mlps": 5.0, "stage3_members": 5.0, "calib": 1.0,
                                    "test": 1.0, "calib_ema": 1.0, "test_ema": 1.0, "test_fgsm": 1.0,
                                    "test_noise": 1.0}
    assert not os.path.exists(os.path.join(port_work, "torch_digits_summary.json"))
    # everything done: a second run resumes with no step
    assert run_digits.run(port_work, "cpu", step=None)["test"] == out["test"]
    run_digits.write_evidence(out, str(tmp_path / "ev"))
    assert sorted(os.listdir(tmp_path / "ev")) == ["RESULTS_digits_torch.md", "torch_digits_summary.json"]


def test_run_digits_fast_on_a_subset_of_the_corpus(tmp_path):
    """The pipeline in process on the CPU at the config's widths: ``--fast``
    (2 epochs a stage) on 8 train and 2 test images of each class."""
    work = tmp_path / "work"
    subset = {}
    for split, n in (("train", 8), ("t10k", 2)):
        x = read_idx(os.path.join(RAW, f"{split}-images-idx3-ubyte"))
        y = read_idx(os.path.join(RAW, f"{split}-labels-idx1-ubyte"))
        keep = np.concatenate([np.flatnonzero(y == c)[:n] for c in range(10)])
        subset[f"{split}-images-idx3-ubyte"] = corpus.idx_bytes(x[keep])
        subset[f"{split}-labels-idx1-ubyte"] = corpus.idx_bytes(y[keep])
    corpus.write(str(work / "digits_root"), subset, gzipped=True)
    with contextlib.redirect_stderr(io.StringIO()):
        out = run_digits.run(str(work), "cpu", fast=True)
    assert out["epochs"] == {"stage1": 2, "stage3": 2} and out["device"] == "cpu"
    for key in ("test", "test_ema_debiased", "test_fgsm_eps0.03", "test_noise_0.1"):
        assert out[key]["num_instances"] == 20, key
        assert all(np.isfinite(v) for v in out[key].values()), key
    assert len(out["stage1b_mlp_val_accs"]) == 5 and out["calibrated_temperature"] > 0
    assert set(out["stage_seconds"]) == {"stage1a_vit", "stage1b_mlps", "stage3_members", "calib", "test",
                                         "calib_ema", "test_ema", "test_fgsm", "test_noise"}
    with open(work / "digits_summary.json") as f:
        assert json.load(f)["test"] == out["test"]


# --------------------------------------------------------------------- lowmem_ab


def _stub_arms(tmp_path, accuracies, dtypes):
    """Arms that print a summary at ``accuracies[name]`` and save member
    states whose moments and EMA are ``lowmem[name]`` (bf16) or float32."""
    def arm(argv):
        name = os.path.basename(argv[argv.index("--exp") + 1])
        if accuracies[name] is None:
            return 0, "no summary\n"
        compute = ConditionalModel(1, 12, 8, 8, 2, 11, device="meta", dtype=torch.float32)
        lowmem = dtypes[name] == torch.bfloat16
        state = create_member_states(compute, torch.Generator().manual_seed(0), make_optimizer("Adam", lowmem=lowmem),
                                     1, lowmem=lowmem, device="cpu")
        ckpt = str(tmp_path / name / "ckpt")
        save_train_state(ckpt, state)
        return 0, "log line\n" + json.dumps({"mode": "train", "best_accuracy": accuracies[name],
                                            "best_ckpt_path": ckpt}) + "\n"
    return arm


@pytest.mark.parametrize(
    "accuracies, dtypes, rc",
    [
        ({"fp32": 80.0, "lowmem": 79.0}, {"fp32": torch.float32, "lowmem": torch.bfloat16}, 0),
        ({"fp32": 80.0, "lowmem": 77.0}, {"fp32": torch.float32, "lowmem": torch.bfloat16}, 1),
        ({"fp32": 80.0, "lowmem": None}, {"fp32": torch.float32, "lowmem": torch.bfloat16}, 1),
        ({"fp32": 80.0, "lowmem": 80.0}, {"fp32": torch.float32, "lowmem": torch.float32}, 1),
    ],
    ids=["within-2-points", "gate-missed", "no-summary", "lowmem-state-in-float32"],
)
def test_lowmem_ab_exits_1_unless_the_gate_and_the_dtypes_hold(tmp_path, monkeypatch, accuracies, dtypes, rc):
    monkeypatch.setattr(lowmem_ab, "cli_arm", _stub_arms(tmp_path, accuracies, dtypes))
    out = tmp_path / "ab.json"
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        assert lowmem_ab.main(["--work", str(tmp_path), "--device", "cpu", "--out", str(out)]) == rc
    result = json.loads(out.read_text())
    assert result["pass"] == (accuracies["lowmem"] is not None and accuracies["lowmem"] >= accuracies["fp32"] - 2)
    assert bool(result["failures"]) == bool(rc)
    if accuracies["lowmem"] is not None:
        for name in ("fp32", "lowmem"):
            assert result[name]["state_dtypes"] == dict.fromkeys(("mu", "nu", "ema"), [str(dtypes[name])])


# ------------------------------------------------------------------ minimal_slice


def _printed(text):
    """{label: value} of the example's printed lines."""
    out = {}
    for line in text.splitlines():
        label, sep, value = line.partition(": ")
        if sep and label in ("guidance heads", "raw sample logits", "per-trial probabilities", "mean probability",
                             "majority vote"):
            out[label] = np.asarray(json.loads(value), np.float64)
    return out


def test_minimal_slice_matches_the_jax_example(monkeypatch):
    """The JAX example's own run (its default small size, its seeds), and
    the port's on the same image, weights and draws (the example's own,
    recorded as it makes them)."""
    jms = _load_script("jax_minimal_slice", os.path.join(REPO, "examples", "minimal_slice.py"))
    seen = {}
    sample = jms.member_mc_sample

    def compiled(method, record=None):  # flax's init/apply as one XLA program instead of op by op
        def call(self, *args):
            out = jax.jit(lambda *a: method(self, *a))(*args)
            if record:
                seen[record] = out
            return out
        return call

    def recorded_sample(cond, member0, x_flat, *args, **kw):
        seen.update(member0=member0, x_flat=x_flat)
        return sample(cond, member0, x_flat, *args, **kw)

    monkeypatch.setattr(JaxGuidance, "init", compiled(JaxGuidance.init, "gvars"))
    monkeypatch.setattr(JaxGuidance, "apply", compiled(JaxGuidance.apply))
    monkeypatch.setattr(JaxConditionalModel, "init", compiled(JaxConditionalModel.init))
    monkeypatch.setattr(jms, "member_mc_sample", recorded_sample)
    monkeypatch.setattr(sys, "argv", ["minimal_slice.py"])
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        assert jms.main() == 0
    want = _printed(printed.getvalue())

    s = minimal_slice.SMALL
    x = np.asarray(seen["x_flat"]).reshape(1, s["img"], s["img"], 3)
    gvars, member0 = seen["gvars"], seen["member0"]
    trial_keys = jax.random.split(jax.random.PRNGKey(3), minimal_slice.TRIALS)
    noise = np.stack([jax_loop_noise(k, (1, 2), minimal_slice.DDIM_STEPS) for k in trial_keys], 1)[:, None]

    _, guidance, member = minimal_slice.build(device="cpu")
    guidance.load_state_dict(guidance_from_flax(jax.tree.map(np.asarray, gvars)))
    member.load_state_dict(members_from_flax(jax.tree.map(lambda v: np.asarray(v)[None], member0)))
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        out = minimal_slice.run(torch.from_numpy(x.copy()), guidance, member, noise=torch.from_numpy(noise))
    got = _printed(printed.getvalue())
    assert sorted(got) == sorted(want)
    for label, w in want.items():
        np.testing.assert_allclose(got[label], w, rtol=0, atol=1.5e-3, err_msg=label)
    assert out["samples"].shape == (minimal_slice.TRIALS, 1, 2)
