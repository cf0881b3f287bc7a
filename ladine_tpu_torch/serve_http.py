"""HTTP front of the port's Predictor, behind a MicroBatcher.

Counterpart of ``examples/serve_http.py``, with the same wire contract:

- ``POST /predict`` takes JSON ``{"images": [...BxHxWx3 floats in [0, 1]...]}``,
  or (``Content-Type: application/octet-stream``) one ``.npy`` array: float32
  in [0, 1], or unsigned ints divided by their dtype's max (uint8 / 255,
  uint16 / 65535). It answers ``{"probs", "majority_vote", "piw",
  "mc_variance"}`` as JSON, or as one ``.npz`` with
  ``Accept: application/octet-stream``. A payload it cannot read gets 400.
- ``GET /health`` returns the geometry and the batcher's counters.
- Any other path gets 404.

    python -m ladine_tpu_torch.serve_http --artifact ./artifact --port 8787
    python -m ladine_tpu_torch.serve_http --artifact ./artifact --preset serving
    python -m ladine_tpu_torch.serve_http --bundle ./bundle --max_batch 70
    python -m ladine_tpu_torch.serve_http --demo --device cpu   # tiny random predictor

``--artifact`` is a ``Predictor.save`` directory; ``--bundle`` an AOT
bundle (``Predictor.export_serving``), served as exported: it takes no
``--preset`` and must carry a program for every batcher bucket up to
``--max_batch``. Concurrent requests coalesce into one device call of at
most ``--max_batch`` images (``infer/batching.py``). It serves on the card
(``--device cuda``, the default) and fails without one unless ``--device
cpu`` is given.
(stdlib ``http.server``: the artifact contract, not a production server.)
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ladine_tpu_torch.infer.batching import MicroBatcher
from ladine_tpu_torch.infer.exported import ExportedPredictor
from ladine_tpu_torch.infer.serve import PRESETS, Predictor

DEMO_GEOMETRY = dict(num_classes=2, num_members=3, vit_depth=3, img_size=16, patch_size=8,
                     embed_dim=16, num_heads=2, mlp_hidden_dims=(16, 8, 8))


def build_demo_predictor(device="cuda", seed: int = 0, **overrides) -> Predictor:
    """A tiny predictor with random weights drawn from ``seed``: 3 members
    of 16 x 16 images, 4 MC trials, DDIM-10. ``overrides`` (e.g. a preset's
    settings) are Predictor arguments."""
    from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance, init_random_
    from ladine_tpu_torch.ops import DiffusionSchedule

    gen = torch.Generator().manual_seed(seed)
    guidance = SEViTGuidance(**DEMO_GEOMETRY, device="cpu")
    model = ConditionalModel(3, 16 * 16 * 3, 8, 8, 2, 101, device="cpu")
    init_random_(guidance, gen)
    init_random_(model, gen)
    kwargs = {"mc_trials": 4, "ddim_steps": 10, **overrides}
    return Predictor(guidance=guidance, model=model,
                     sched=DiffusionSchedule.create("linear", 100, device="cpu"), device=device, **kwargs)


def read_images(body: bytes, content_type: str) -> np.ndarray:
    """A request body -> float32 images; ValueError (and friends) on a
    payload that is not one."""
    if content_type.startswith("application/octet-stream"):
        images = np.load(io.BytesIO(body), allow_pickle=False)
        if not isinstance(images, np.ndarray):  # e.g. the .npz of a response
            raise ValueError(f"binary body must be a single .npy array, got {type(images).__name__}")
        if images.dtype.kind == "u":
            return images.astype(np.float32) / float(np.iinfo(images.dtype).max)
        if images.dtype.kind == "f":
            return np.asarray(images, np.float32)
        # signed ints (raw CT ranges) have no one normalization: the client picks
        raise ValueError(f"dtype {images.dtype} not supported: send float in [0,1] or unsigned int")
    return np.asarray(json.loads(body)["images"], np.float32)


def health_info(predictor) -> dict:
    """What ``GET /health`` reports of a ``Predictor`` or an
    ``ExportedPredictor`` (its batch sizes and exported settings)."""
    if isinstance(predictor, ExportedPredictor):
        return {"kind": "aot_bundle", "image_size": predictor.img_size, "members": predictor.noise_shape[1],
                "batch_sizes": sorted(predictor.programs), **predictor.settings,
                "device": str(predictor.device)}
    return {"image_size": predictor.guidance.img_size, "members": int(predictor.guidance.num_members),
            "mc_trials": predictor.mc_trials, "ddim_steps": predictor.ddim_steps,
            "device": str(predictor.device)}


def make_handler(info: dict, batcher: MicroBatcher):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, content_type: str):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path != "/health":
                return self._json(404, {"error": "GET /health or POST /predict"})
            self._json(200, {"status": "ok", **info, "batching": batcher.stats()})

        def do_POST(self):
            if self.path != "/predict":
                return self._json(404, {"error": "POST /predict"})
            try:
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                images = read_images(body, self.headers.get("Content-Type", "application/json"))
                out = batcher.predict(images)
            except (KeyError, TypeError, ValueError, OSError, zipfile.BadZipFile) as e:
                # BadZipFile / OSError: np.load on a corrupt zip-magic body
                return self._json(400, {"error": f"{type(e).__name__}: {e}"})
            if "application/octet-stream" in self.headers.get("Accept", ""):
                buf = io.BytesIO()
                np.savez(buf, **out)
                self._send(200, buf.getvalue(), "application/octet-stream")
            else:
                self._json(200, {k: v.tolist() for k, v in out.items()})

        def log_message(self, *a):
            print(f"[serve] {self.address_string()} {a[0] % a[1:]}", file=sys.stderr)

    return Handler


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--artifact", type=str, help="a Predictor.save directory")
    src.add_argument("--bundle", type=str, help="an AOT bundle (Predictor.export_serving), served as exported")
    src.add_argument("--demo", action="store_true", help="a tiny predictor with random weights")
    ap.add_argument("--preset", type=str, default=None, choices=sorted(PRESETS),
                    help="named sampler/quantization operating point; default: the artifact's settings")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--max_batch", type=int, default=70,
                    help="micro-batch cap: concurrent requests coalesce into one call of up to "
                         "this many images")
    ap.add_argument("--max_wait_ms", type=float, default=10.0,
                    help="how long a lone request waits for co-riders")
    args = ap.parse_args(argv)

    if args.bundle:
        if args.preset:
            ap.error("--bundle serves the exported program as it is: re-export it at the preset you "
                     "want, or serve a live --artifact")
        predictor = ExportedPredictor.load(args.bundle, device=args.device)
        missing = [b for b in MicroBatcher.bucket_sizes(args.max_batch) if b not in predictor.programs]
        if missing:
            ap.error(f"bundle lacks programs for batcher buckets {missing} at --max_batch {args.max_batch}; "
                     f"re-export with batch_sizes=MicroBatcher.bucket_sizes({args.max_batch}) or lower "
                     "--max_batch")
    elif args.demo:
        predictor = build_demo_predictor(args.device, **(PRESETS[args.preset] if args.preset else {}))
    else:
        predictor = Predictor.load(args.artifact, preset=args.preset, device=args.device)
    info = health_info(predictor)
    batcher = MicroBatcher(predictor.predict, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)
    server = ThreadingHTTPServer(("127.0.0.1", args.port), make_handler(info, batcher))
    size = info["image_size"]
    print(f"[serve] listening on 127.0.0.1:{args.port} (img {size}x{size}, {predictor.device})",
          file=sys.stderr, flush=True)
    try:
        server.serve_forever()
    finally:
        batcher.close()


if __name__ == "__main__":
    main()
