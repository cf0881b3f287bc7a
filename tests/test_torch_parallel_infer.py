"""The port's sharded inference on a (2, 2) mesh of four ``gloo`` ranks on
the CPU against its one-process run from the same seeds
(``tests/torch_mesh.py::infer_case``; one spawned group): the engine's
``nested_ensemble_sample`` with its draws from a generator, ``Predictor``
at ``parity`` and at ``fast`` (the int8 eps, encoder and mapping heads,
their member rows on each rank), ``Predictor.load(mesh=)`` of a saved
predictor at ``fast``, and ``evaluate_ensemble`` with
corruptions and PGD, each at a batch of 8 and a tail batch of 5 that does
not tile 'data' (it runs whole on each member row). Votes equal; samples,
``probs``, PIW and variance within rtol 1e-4 and atol 1e-5
(``tests/test_serve_sharded.py``'s bar for the JAX package). A rank of the
(2, 2) mesh holds half the members' bytes of one process, float and int8."""

import numpy as np
import pytest

import torch_mesh as TM
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("infer")
    artifact = str(tmp / "artifact")
    TM.save_infer_artifact(artifact)
    sharded = TM.run_world(TM.infer_world, 4, tmp, artifact)
    return sharded, TM.infer_case(artifact)


@pytest.mark.parametrize("b", TM.EVAL_BATCHES)
def test_engine_samples_match_one_process(runs, b):
    sharded, one = runs
    got, want = sharded[f"engine_{b}"], one[f"engine_{b}"]
    assert got.shape == want.shape == (TM.INFER_MEMBERS, 3, b, 2)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("preset", ["parity", "fast", "load"])
@pytest.mark.parametrize("b", TM.EVAL_BATCHES)
def test_predictor_on_a_mesh_matches_one_process(runs, preset, b):
    sharded, one = runs
    got, want = sharded[f"{preset}_{b}"], one[f"{preset}_{b}"]
    np.testing.assert_array_equal(got["majority_vote"], want["majority_vote"])
    for k in ("probs", "piw", "mc_variance"):
        assert got[k].shape == want[k].shape and np.isfinite(got[k]).all()
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_evaluate_ensemble_on_a_mesh_matches_one_process(runs):
    sharded, one = runs
    got, want = sharded["eval"], one["eval"]
    assert got["samples"].shape == want["samples"].shape == (TM.INFER_MEMBERS * 3, sum(TM.EVAL_BATCHES), 2)
    np.testing.assert_allclose(got["samples"], want["samples"], **TOL)
    for k in ("majority_vote_accuracy", "ece", "nll"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("holder", ["parity", "fast", "load", "eval"])
def test_a_rank_holds_its_member_rows_alone(runs, holder):
    sharded, one = runs
    assert sharded[f"bytes_{holder}"] * 2 == one[f"bytes_{holder}"] > 0


def test_a_mesh_predictor_refuses_save_and_export(runs):
    assert runs[0]["refused"] == ["save", "export_serving"]
