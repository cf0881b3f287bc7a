"""The port's HTTP server holds the wire contract of examples/serve_http.py.

The contract's tests are those of tests/test_serve_http.py, run here
against ``python -m ladine_tpu_torch.serve_http --demo --device cpu`` over a
real socket (the same tiny geometry: 3 members, 16 x 16 images): JSON and
``.npy`` in, JSON and ``.npz`` out, uint8/uint16 normalised, 400 on a bad
payload, 404 on an unknown path. Then the server on a ``Predictor.save``
artifact with a preset, and without a card when the card is asked for.
"""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_serve_http import (  # noqa: F401  (collected here against this module's server)
    _free_port,
    _post,
    test_bad_payloads_400,
    test_health_geometry,
    test_json_roundtrip,
    test_npy_request_npz_response,
    test_npy_uint8_normalized,
    test_npy_uint16_normalized,
    test_unknown_path_404,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _start(*args):
    port = _free_port()
    proc = subprocess.Popen([sys.executable, "-m", "ladine_tpu_torch.serve_http", "--port", str(port), *args],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    deadline = time.time() + 60
    while True:
        try:
            with urllib.request.urlopen(url + "/health", timeout=5) as r:
                return proc, url, json.loads(r.read())
        except (urllib.error.URLError, ConnectionError):
            if proc.poll() is not None or time.time() > deadline:
                proc.kill()  # before reading: a live process's pipe never ends
                proc.wait()
                out = proc.stdout.read().decode(errors="replace")
                raise RuntimeError(f"server did not come up:\n{out[-2000:]}")
            time.sleep(0.2)


@pytest.fixture(scope="module")
def server():
    proc, url, _ = _start("--demo", "--device", "cpu", "--max_wait_ms", "1")
    try:
        yield url
    finally:
        proc.kill()
        proc.wait()


def test_health_names_the_device(server):
    with urllib.request.urlopen(server + "/health", timeout=30) as r:
        h = json.loads(r.read())
    assert h["device"] == "cpu" and h["mc_trials"] == 4 and h["ddim_steps"] == 10


def test_serves_a_saved_artifact_at_a_preset(tmp_path):
    from ladine_tpu_torch.serve_http import build_demo_predictor

    build_demo_predictor(device="cpu").save(str(tmp_path / "artifact"))
    proc, url, health = _start("--artifact", str(tmp_path / "artifact"), "--preset", "fast",
                               "--device", "cpu", "--max_batch", "4")
    try:
        assert health["ddim_steps"] == 10 and health["members"] == 3 and health["image_size"] == 16
        imgs = np.random.default_rng(5).random((6, 16, 16, 3)).astype(np.float32)  # split: cap 4
        body, _ = _post(url, json.dumps({"images": imgs.tolist()}).encode(),
                        {"Content-Type": "application/json"})
        probs = np.asarray(json.loads(body)["probs"])
        assert probs.shape == (6, 2) and np.isfinite(probs).all()
        with urllib.request.urlopen(url + "/health", timeout=30) as r:
            assert json.loads(r.read())["batching"]["device_calls"] == 2
    finally:
        proc.kill()
        proc.wait()


def test_fails_without_a_card_unless_asked_for_the_cpu():
    out = subprocess.run([sys.executable, "-m", "ladine_tpu_torch.serve_http", "--demo", "--port",
                          str(_free_port())], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and "device='cpu'" in out.stderr
