"""The port's evidence pipeline against the JAX repository's scripts, on the
CPU: ``examples/make_synth_medical.py``, ``run_results.py``,
``render_results.py``, ``sync_evidence.py`` and ``profile_serving.py``
against ``scripts/`` (loaded by path).

* The generator: ``make_image`` and ``bayes_accuracy`` equal the JAX
  script's for several seeds and both classes; a whole tree (label noise
  on) holds the same files and pixels.
* The plan of ``run_results``: both drivers run with their step runner
  replaced by a recorder that writes each step's artifact; the same steps,
  flags, seeds, epochs and batch sizes in the same order, full and
  ``--tiny``; a second run resumes with no step; ``--fast`` at the full
  widths is refused before any step (ROADMAP F8).
* ``md_row``, ``uncertainty_lines``, ``suite_dict`` and ``_ema_mode`` equal
  the JAX script's; the port's renderer on the committed
  ``evidence/report_*.json`` gives the JAX renderer's table and
  uncertainty lines; ``sync_evidence`` writes only under
  ``evidence/torch/`` and refuses truncated JSON.
* One tiny end-to-end run in process on a cut corpus, then a second call
  that runs no step; ``--real`` on a reference ``.pth`` tree that the
  port's exporters write, at tiny widths, and again with no step;
  ``crop_chains`` on the run's weights beside a crop row of the suite.
* ``profile_serving --tiny --device cpu`` prints every key of the JAX
  record, on the JAX script's constants.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import shutil
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ladine_tpu.models import ConditionalModel as JaxConditionalModel
from ladine_tpu.models import SEViTGuidance as JaxGuidance
from ladine_tpu_torch.examples import make_synth_medical as synth
from ladine_tpu_torch.examples import crop_chains, profile_serving, render_results, run_results, sync_evidence
from ladine_tpu_torch.examples.run_digits import run_step
from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance, init_random_
from ladine_tpu_torch.utils import guidance_from_flax, members_from_flax
from ladine_tpu_torch.utils.torch_convert import (
    export_conditional_model,
    export_mapping_mlp,
    export_vit,
    save_torch_state_dict,
)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
TINY = os.path.join(REPO, "configs", "synthetic_tiny.yml")
CUT = {"training": 16, "validation": 16, "testing": 16}  # a tiny batch of 32 in each evaluated split


def _load_script(name):
    """A script of ``scripts/`` as a module, with the signal handlers its
    import installs put back afterwards."""
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    sys.path.insert(0, SCRIPTS)
    try:
        spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(SCRIPTS, f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(SCRIPTS)
        for s, h in handlers.items():
            signal.signal(s, h)
    return module


@pytest.fixture(scope="module")
def jrr():
    return _load_script("run_results")


# ------------------------------------------------------------------ the corpus


def test_make_image_and_bayes_accuracy_equal_the_jax_script():
    script = _load_script("make_synth_medical")
    assert synth.bayes_accuracy() == script.bayes_accuracy()
    for seed in (0, 1, 17):
        for cls in (0, 1):
            a, b = np.random.default_rng(seed), np.random.default_rng(seed)
            got, want = synth.make_image(cls, a), script.make_image(cls, b)
            assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want), (seed, cls)
            assert a.random() == b.random()  # the streams stay in step


def test_corpus_tree_equals_the_jax_scripts(tmp_path, monkeypatch):
    script = _load_script("make_synth_medical")
    flags = ["--n", "3", "--test_n", "2", "--seed", "5", "--label_noise", "0.5"]
    monkeypatch.setattr(sys, "argv", ["make_synth_medical.py", "--out", str(tmp_path / "jax"), *flags])
    with contextlib.redirect_stdout(io.StringIO()) as theirs:
        script.main()
    with contextlib.redirect_stdout(io.StringIO()) as ours:
        assert synth.main(["--out", str(tmp_path / "port"), *flags]) == 0
    assert ours.getvalue() == theirs.getvalue().replace("jax", "port")

    def tree(root):
        return {os.path.relpath(os.path.join(d, f), root): np.asarray(Image.open(os.path.join(d, f)))
                for d, _, fs in os.walk(root) for f in fs}

    got, want = tree(tmp_path / "port"), tree(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) == 2 * (3 + 0 + 2)
    for name, img in want.items():
        assert img.shape == (224, 224, 3) and np.array_equal(got[name], img), name


# ------------------------------------------------------------ the plan of run_results


def _write_artifacts(name, argv, log_path):
    """What a completed step leaves behind, for the drivers' resume checks."""
    def value(flag):
        return argv[argv.index(flag) + 1]

    def meta(path, **kw):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "ladine_meta.json"), "w") as f:
            json.dump({"ema_init": "zero", **kw}, f)

    def report(path, **kw):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        r = {k: 50.0 for k in ("mean_confidence_accuracy", "majority_vote_accuracy")}
        r.update(ece=0.1, nll=0.7, brier=0.5, piw_correct=[1.0, None], piw_incorrect=[],
                 mc_variance_correct=[0.5], mc_variance_incorrect=[0.75], **kw)
        with open(path, "w") as f:
            json.dump(r, f)

    logs = os.path.join(value("--exp"), "logs", value("--doc")) if "--exp" in argv else None
    if name == "train_transformer":
        meta(os.path.join(value("--out"), "vit_ChestXRay"))
        with open(log_path, "a") as f:
            f.write(json.dumps({"mode": "train_transformer", "best_val_accuracy": 91.5}) + "\n")
    elif name == "train_mapping":
        meta(os.path.join(value("--out"), "ChestXRay", "MLPs", f"block_{value('--mlp_idx')}"), accuracy=90.5)
    elif name == "convert":
        out = value("--out")
        n = argv.index("--out") - argv.index("--diffusion_ckpt") - 1
        for d in ["guidance_ChestXRay"] + [f"member_{k}" for k in range(n)]:
            meta(os.path.join(out, d))
    elif "--eval_guidance" in argv:
        with open(log_path, "a") as f:
            f.write(json.dumps({"mode": "eval_guidance", "majority_vote_accuracy": 92.0}) + "\n")
    elif "--train" in argv:
        meta(os.path.join(logs, f"diffu{value('--mlp_idx')}_ckpt_best_eph3_acc50.0000"))
        with open(os.path.join(logs, "train_complete.json"), "w") as f:
            json.dump({}, f)
    elif "--suite" in argv:
        with open(value("--suite")) as f:
            rows = json.load(f)
        for row in rows:
            report(os.path.join(logs, f"report_{row}.json"), temperature=0.125)
    else:
        report(os.path.join(logs, "report.json"), calibrated_temperature=0.5 if "--eval_ema" in argv else 0.125)


def _normal(name, argv, work, config):
    return [name] + [a.replace(config, "CONFIG").replace(work, "W") for a in argv]


def _jax_plan(jrr, tmp_path, monkeypatch, flags):
    work, repo = str(tmp_path / "jax"), str(tmp_path / "jaxrepo")
    os.makedirs(repo)  # where the full run writes its RESULTS.md
    steps, suites = [], []

    def sh(args, log_path, env=None, done_check=None, **_):
        if args[1] == "-m":
            name, argv = args[2].rsplit(".", 1)[1], args[3:]
            assert args[2] == "ladine_tpu.cli." + name
            steps.append(_normal(name, argv, work, os.path.join(repo, "configs")))
            if "--suite" in argv:
                with open(argv[argv.index("--suite") + 1]) as f:
                    suites.append(json.load(f))
            _write_artifacts(name, argv, log_path)
        else:
            steps.append([os.path.basename(args[1])] + [a.replace(work, "W") for a in args[2:]])
            os.makedirs(os.path.join(args[args.index("--out") + 1], "testing"))
        assert done_check is None or done_check()
        return 1.0

    monkeypatch.setattr(jrr, "sh", sh)
    monkeypatch.setattr(jrr, "REPO", repo)
    monkeypatch.syspath_prepend(SCRIPTS)  # its bayes_accuracy import; sys.path is restored after
    monkeypatch.setattr(sys, "argv", ["run_results.py", "--work", work, "--cpu", *flags])
    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()):
        jrr.main()
    return steps, suites


def _port_plan(tmp_path, monkeypatch, **kw):
    work = str(tmp_path / "port")
    steps, suites, corpora = [], [], []

    def step(module, argv, log_path, done=None):
        name = module.rsplit(".", 1)[1]
        assert module == "ladine_tpu_torch.cli." + name and argv[:2] == ["--device", "cpu"]
        steps.append(_normal(name, ["--cpu"] + argv[2:], work, os.path.join(REPO, "configs")))
        if "--suite" in argv:
            with open(argv[argv.index("--suite") + 1]) as f:
                suites.append(json.load(f))
        _write_artifacts(name, argv, log_path)
        assert done is None or done()
        return 1.0

    def write_corpus(out, counts):
        corpora.append((out.replace(work, "W"), counts))
        os.makedirs(out, exist_ok=True)

    monkeypatch.setattr(synth, "write_corpus", write_corpus)
    out = run_results.run(work, "cpu", step=step, **kw)
    return steps, suites, corpora, out, work, step


@pytest.mark.parametrize("tiny", [False, True], ids=["full", "tiny"])
def test_run_results_plans_the_jax_steps(jrr, tiny, tmp_path, monkeypatch):
    """The same CLI steps, flags, seeds, epochs and batch sizes in the same
    order, ``ladine_tpu.cli.X`` -> ``ladine_tpu_torch.cli.X`` and ``--cpu``
    -> ``--device cpu``, and the same suite files; the corpus is written in
    process with the script's counts; a second run runs no step."""
    jax_steps, jax_suites = _jax_plan(jrr, tmp_path, monkeypatch, ["--tiny"] if tiny else [])
    steps, suites, corpora, out, work, step = _port_plan(tmp_path, monkeypatch, tiny=tiny)
    n = ["--n", "60"] if tiny else ["--n", "250", "--test_n", "600"]
    assert jax_steps[0] == ["make_synth_medical.py", "--out", "W/synth_ds", *n]
    assert corpora == [("W/synth_ds", synth.split_counts(60) if tiny else synth.split_counts(250, 600))]
    assert steps == jax_steps[1:] and suites == jax_suites
    assert len(steps) == 1 + 5 + 1 + 5 + 1 + 1 + (0 if tiny else 1) + 2
    assert out["steps"] == len(steps) + 1 and out["stage1b_mlp_val_accs"] == [90.5] * 5
    assert out["ema_mode"] == "debiased" and out["device"] == "cpu"
    assert sorted(out["reports"]) == sorted(["calib", "calib_ema", "ema"] + list(run_results.suite_dict(tiny))
                                            + ([] if tiny else ["cover_fp32"]))
    assert os.path.exists(os.path.join(work, "RESULTS_torch.md"))
    assert not os.path.exists(os.path.join(work, "RESULTS.md"))
    assert run_results.run(work, "cpu", tiny=tiny, step=step)["steps"] == 0  # a resumed run: nothing left


def test_a_seed_offset_moves_every_training_seed_and_nothing_else(tmp_path, monkeypatch):
    """``run(seed=100)``: the ViT and the MLPs train from seed 142 (their
    CLIs' default is 42), member k from 1100 + k; every other step and flag
    is the JAX script's, and the file says so."""
    base = _port_plan(tmp_path / "a", monkeypatch, tiny=True)[0]
    moved, _, _, out, work, _ = _port_plan(tmp_path / "b", monkeypatch, tiny=True, seed=100)
    assert len(moved) == len(base)
    for got, want in zip(moved, base):
        if want[0] in ("train_transformer", "train_mapping"):
            assert got == want + ["--seed", "142"]
        elif "--train" in want:
            i = want.index("--seed")
            assert got == want[:i + 1] + [str(int(want[i + 1]) + 100)] + want[i + 2:]
        else:
            assert got == want
    assert out["seed_offset"] == 100
    assert "NOTE: training seeds offset by 100" in open(os.path.join(work, "RESULTS_torch.md")).read()


def test_fast_at_full_widths_evaluates_no_image_and_is_refused(tmp_path):
    """F8: ``--fast`` writes 18 validation and 18 test images a class; at
    ``configs/synthetic224.yml``'s test batch of 70 with ``drop_last`` they
    fill no batch. The JAX runner counts 36 // 70 = 0 batches; the port
    refuses before it writes or trains anything."""
    assert synth.split_counts(60) == {"training": 60, "validation": 18, "testing": 18}
    assert (2 * 18) // 70 == 0
    with pytest.raises(ValueError, match="F8"):
        run_results.run(str(tmp_path / "w"), "cpu", fast=True, step=None)
    assert not os.path.exists(tmp_path / "w")


# ------------------------------------------------------- shared helpers and renderer


def test_helpers_equal_the_jax_scripts(jrr, tmp_path):
    for fast in (False, True):
        assert run_results.suite_dict(fast) == jrr.suite_dict(fast)
        assert list(run_results.suite_dict(fast)) == list(jrr.suite_dict(fast))
    assert run_results.CORRUPTION_ROWS == jrr.CORRUPTION_ROWS
    rows = {}
    for path in sorted(os.listdir(os.path.join(REPO, "evidence"))):
        if path.startswith("report_"):
            with open(os.path.join(REPO, "evidence", path)) as f:
                rows[path] = json.load(f)
    rows["missing"] = None
    rows["no ci"] = {k: v for k, v in rows["report_full.json"].items() if "ci95" not in k}
    for name, r in rows.items():
        assert run_results.md_row(name, r) == jrr.md_row(name, r)
    rows["empty"] = {"piw_correct": None, "piw_incorrect": [float("nan")], "mc_variance_correct": [],
                     "mc_variance_incorrect": [1.0, None]}
    assert run_results.uncertainty_lines(rows) == jrr.uncertainty_lines(rows)
    for init in ("zero", "copy", None):
        d = tmp_path / str(init)
        d.mkdir()
        if init:
            (d / "ladine_meta.json").write_text(json.dumps({"ema_init": init}))
        assert run_results._ema_mode(str(d)) == jrr._ema_mode(str(d))


def test_renderer_gives_the_jax_renderers_table_on_the_committed_reports(tmp_path, monkeypatch):
    script = _load_script("render_results")
    monkeypatch.setattr(sys, "argv", ["render_results.py", "--out", str(tmp_path / "jax.md")])
    with contextlib.redirect_stdout(io.StringIO()):
        script.main()
    with contextlib.redirect_stdout(io.StringIO()):
        assert render_results.main(["--reports", os.path.join(REPO, "evidence"), "--reference", "",
                                    "--out", str(tmp_path / "port.md")]) == 0

    def table(path):
        lines = open(path).read().splitlines()
        return [line for line in lines if line.startswith(("|", "- calibrated"))]

    want = table(tmp_path / "jax.md")
    assert table(tmp_path / "port.md") == want and len(want) > 3 + 2 + len(render_results.ROWS)
    assert render_results.ROWS == script.ROWS
    # beside the JAX rows: two more cells a row, the port's cells first
    text = render_results.render(os.path.join(REPO, "evidence"), os.path.join(REPO, "evidence"))
    rows = [line for line in text.splitlines() if line.startswith("| clean, full")]
    full = json.load(open(os.path.join(REPO, "evidence", "report_full.json")))
    assert rows[0].endswith(f"| {full['majority_vote_accuracy']:.2f} | {full['ece']:.4f} |")


def test_sync_writes_only_under_evidence_torch_and_refuses_truncated_json(tmp_path):
    work, repo = tmp_path / "work", tmp_path / "repo"
    logs = work / "exp" / "logs"
    for rel, text in (("calib/report.json", "{}"), ("test_ema/report.json", '{"ece": 0.1}'),
                      ("suite/report_d50.json", '{"ece": 0.2}'), ("suite/report_full.json", '{"ece": 0.'),
                      ("suite/reliability.png", "png"), ("suite/other.txt", "x")):
        (logs / rel).parent.mkdir(parents=True, exist_ok=True)
        (logs / rel).write_text(text)
    (repo / "evidence").mkdir(parents=True)
    names = ["report_calib.json", "report_ema.json", "report_d50.json", "reliability.png"]
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        with pytest.raises(RuntimeError, match="report_full"):
            sync_evidence.sync(str(work), dry_run=True, evidence=str(repo / "evidence"))
        assert os.listdir(repo / "evidence") == []
        with pytest.raises(RuntimeError, match="report_full"):
            sync_evidence.sync(str(work), evidence=str(repo / "evidence"))
    lines = printed.getvalue().splitlines()
    assert [line.rsplit("/", 1)[1] for line in lines if line.startswith("would copy")] == names
    assert sum(line.startswith("SKIPPED") for line in lines) == 2
    files = sorted(os.path.relpath(os.path.join(d, f), repo) for d, _, fs in os.walk(repo) for f in fs)
    assert files == sorted(f"evidence/torch/{n}" for n in names)


# ------------------------------------------------------------ end to end on the CPU


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """``run(..., tiny=True, fast=True)`` on a cut corpus, once a module."""
    work = str(tmp_path_factory.mktemp("results") / "work")
    with contextlib.redirect_stderr(io.StringIO()):
        out = run_results.run(work, "cpu", fast=True, tiny=True, corpus=CUT)
    return work, out


def test_tiny_run_end_to_end_then_resumes_with_no_step(tiny_run, tmp_path):
    work, out = tiny_run
    assert out["steps"] == 1 + 1 + 5 + 1 + 5 + 1 + 1 + 2 and out["device"] == "cpu"
    assert out["epochs"] == {"stage1": 2, "stage3": 4} and out["corpus"] == CUT
    suite = run_results.suite_dict(True)
    assert set(out["reports"]) == {"calib", "calib_ema", "ema", *suite}
    for name, r in out["reports"].items():
        assert r["num_instances"] == 2 * CUT["validation" if name.startswith("calib") else "testing"], name
        for key in ("majority_vote_accuracy", "mean_confidence_accuracy", "ece", "nll", "brier"):
            assert np.isfinite(r[key]), (name, key)
    assert set(out["stage_seconds"]) == {"corpus", "stage1a_vit", "stage1b_mlps", "guidance_eval",
                                         "stage3_members", "calib", "suite", "calib_ema", "test_ema"}
    text = open(os.path.join(work, "RESULTS_torch.md")).read()
    assert "Wall seconds by stage on cpu" in text and "| clean, DDIM-50 eta=1 (serving sampler) | " in text
    assert not os.path.exists(os.path.join(work, "RESULTS.md"))
    ev = tmp_path / "ev"
    with contextlib.redirect_stdout(io.StringIO()):
        again = run_results.run(work, "cpu", fast=True, tiny=True, corpus=CUT, step=None, evidence=str(ev))
    assert again["steps"] == 0 and again["reports"] == out["reports"]
    # --evidence: the reports synced into ev/torch, the file rendered from them
    assert sorted(os.listdir(ev)) == ["RESULTS_torch.md", "torch"]
    names = os.listdir(ev / "torch")
    assert "results_summary.json" in names and len(names) == 1 + len(out["reports"])
    assert render_results.render(str(ev / "torch")) == text
    assert (ev / "RESULTS_torch.md").read_text() == render_results.render(str(ev / "torch"), str(ev))


def _reference_tree(root, members=5):
    """The reference layout at ``configs/synthetic_tiny.yml``'s widths from
    seeded port modules: vit_base_patch16_224_ChestXRay.pth, MLPs/block_k.pth,
    diffu{k}_ckpt_best_eph0_acc0.0000.pth."""
    g = init_random_(SEViTGuidance(2, members, 5, 32, 8, 32, 2, (32, 16, 8), device="cpu"),
                     torch.Generator().manual_seed(0))
    m = init_random_(ConditionalModel(members, 32 * 32 * 3, 32, 32, 2, 51, device="cpu"),
                     torch.Generator().manual_seed(1))
    os.makedirs(os.path.join(root, "MLPs"))
    save_torch_state_dict(export_vit(g), os.path.join(root, "vit_base_patch16_224_ChestXRay.pth"))
    for k in range(members):
        save_torch_state_dict(export_mapping_mlp(g, k), os.path.join(root, "MLPs", f"block_{k}.pth"))
        save_torch_state_dict(export_conditional_model(m, k),
                              os.path.join(root, f"diffu{k}_ckpt_best_eph0_acc0.0000.pth"),
                              wrapper_key="noise_estimator")


def test_real_flow_on_a_reference_tree(tiny_run, tmp_path):
    work, _ = tiny_run
    _reference_tree(str(tmp_path / "pretrained"))
    args = run_results.build_parser().parse_args([
        "--real", "--pretrained_dir", str(tmp_path / "pretrained"), "--dataroot", os.path.join(work, "synth_ds"),
        "--config", TINY, "--work", str(tmp_path / "real"), "--device", "cpu", "--fast"])
    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()):
        out = run_results.run_real(args)
    text = open(out).read()
    assert "| clean, full 1000-step chain (parity workload) | " in text and "| attack: FGSM" in text
    sdir = tmp_path / "real" / "exp" / "logs" / "suite"
    for row in run_results.suite_dict(True):
        r = json.load(open(sdir / f"report_{row}.json"))
        assert r["num_instances"] == 2 * CUT["testing"] and np.isfinite(r["ece"]), row
    calls = []
    run_results.run_real(args, step=lambda *a, **k: calls.append(a))
    assert calls == []


def test_crop_chains_give_the_crop_row_image_by_image(tiny_run, tmp_path):
    """``examples/crop_chains`` on the tiny run's weights, beside the crop
    row that ``cli.main --suite`` writes for them: its bf16 crop arm has the
    row's vote accuracy and per-class variances, ``predict``'s variance is
    its samples', and the clean arm differs from the crop arm."""
    work = str(tmp_path / "work")
    shutil.copytree(tiny_run[0], work)
    exp = os.path.join(work, "exp")
    temperature = json.load(open(os.path.join(exp, "logs", "calib", "report.json")))["calibrated_temperature"]
    ckpts = [run_results.best_ckpt(exp, f"member{k}") for k in range(run_results.MEMBERS)]
    common = ["--temperature", str(temperature), "--config", TINY, "--dataroot", os.path.join(work, "synth_ds"),
              "--exp", exp, "--diffusion_ckpt", *ckpts]
    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()):
        run_results.run_suite_rows({"crop": run_results.suite_dict(False)["crop"]}, str(tmp_path / "suite.json"),
                                   os.path.join(exp, "logs", "suite"), ["--device", "cpu"], common,
                                   str(tmp_path / "log"), lambda stage, *a, **k: run_step(*a, **k))
        record = crop_chains.run(work, "cpu")
    row = json.load(open(os.path.join(exp, "logs", "suite", "report_crop.json")))
    n = 2 * CUT["testing"]
    assert record["images"] == n and sorted(record["index"]) == list(range(n))
    assert set(record["arms"]) == {"bf16_crop", "bf16_clean", "fp32_crop", "fp32_clean", "bf16_crop_interpolate"}
    crop = record["summary"]["bf16_crop"]
    assert crop["mv_accuracy"] == row["majority_vote_accuracy"]
    for key in ("mc_variance_correct", "mc_variance_incorrect"):
        np.testing.assert_allclose(crop[key], row[key], rtol=1e-6, atol=0)
    assert all(s["predict_vs_samples_max_diff"] == 0 for s in record["summary"].values())
    assert record["arms"]["bf16_crop"]["var"] != record["arms"]["bf16_clean"]["var"]
    assert all(len(a["member_var"]) == n and len(a["member_var"][0]) == 5 for a in record["arms"].values())
    assert [o["image"] for o in record["outliers"]] == [
        record["index"][i] for i in range(n) if any(a["var"][i] > 1.0 for a in record["arms"].values())]


# ------------------------------------------------------------------ profile_serving


def _jax_materialize(shapes, scale=0.02):
    """``scripts/profile_serving.py``'s ``materialize`` (a closure of its main)."""
    i = [0]

    def fill(s):
        i[0] += 1
        return np.full(s.shape, scale * ((i[0] % 7) - 3) / 3.0, np.float32)

    return jax.tree.map(fill, shapes)


def test_profile_serving_weights_are_the_jax_scripts_constants():
    m, img, feat, T = 5, 32, 64, 50
    jg = JaxGuidance(num_classes=2, num_members=m, vit_depth=m, img_size=img, patch_size=8, embed_dim=32,
                     num_heads=4, mlp_hidden_dims=(64, 32, 16))
    jc = JaxConditionalModel(data_dim=img * img * 3, feature_dim=feat, hidden_dim=feat, y_dim=2, n_steps=T + 1)
    gvars = _jax_materialize(jax.eval_shape(lambda: jg.init(jax.random.PRNGKey(1), jnp.zeros((1, img, img, 3)))))
    one = _jax_materialize(jax.eval_shape(lambda: jc.init(
        jax.random.PRNGKey(2), jnp.zeros((1, img * img * 3)), jnp.zeros((1, 2)), jnp.asarray(0),
        jnp.full((1, 2), 0.5))))
    stacked = dict(jax.tree.map(lambda x: np.broadcast_to(x, (m,) + x.shape), one))
    stacked["batch_stats"] = jax.tree.map(lambda x: np.abs(x) + 1.0, stacked["batch_stats"])
    g = SEViTGuidance(2, m, m, img, 8, 32, 4, (64, 32, 16), device="cpu")
    c = ConditionalModel(m, img * img * 3, feat, feat, 2, T + 1, device="cpu")
    profile_serving.materialize(g, "guidance")
    profile_serving.materialize(c, "members")
    for ours, want in ((g.state_dict(), guidance_from_flax(gvars)), (c.state_dict(), members_from_flax(stacked))):
        assert set(want) <= set(ours)
        for k, v in want.items():
            assert torch.equal(ours[k], v), k


def test_profile_serving_prints_every_key_of_the_jax_record(capsys):
    src = open(os.path.join(SCRIPTS, "profile_serving.py")).read()
    keys = set(re.findall(r'\("(\w+_ms)", ', src)) | set(re.findall(r'results\["(\w+)"\] =', src))
    assert {"vit_only_ms", "scan_pallas_v2_ms", "heads_int8_ms", "img_per_sec_subset", "batch"} <= keys
    flags = ["--tiny", "--device", "cpu", "--reps", "1", "--int8", "--int8_encode", "--pallas_int8", "--pallas"]
    assert set(re.findall(r'add_argument\("(--\w+)"', src)) - {"--cpu"} <= \
        {a.option_strings[0] for a in profile_serving.build_parser()._actions}
    assert profile_serving.main(flags) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    record = json.loads(lines[-1])
    assert lines[-2] == "cpu" and set(record) == keys and record["batch"] == 8
    assert all(np.isfinite(v) for v in record.values())
    # the fixed costs are differences of two timings: on a loaded CPU either sign
    assert all(v > 0 for k, v in record.items() if not k.startswith("fixed_cost")), record


def test_run_results_takes_the_jax_scripts_flags():
    """``run_results``' flags are the JAX script's, ``--cpu`` -> ``--device``."""
    src = open(os.path.join(SCRIPTS, "run_results.py")).read()
    theirs = set(re.findall(r'add_argument\("(--\w+)"', src)) - {"--cpu"}
    ours = {a.option_strings[0] for a in run_results.build_parser()._actions if a.option_strings}
    assert theirs | {"--device", "--evidence", "-h"} == ours
