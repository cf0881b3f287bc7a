"""A copy of the benchmark at ``configs/synthetic_tiny.yml``'s widths, for
the CPU tests: the same files, the configurations cut to tiny widths, 50
timesteps and 2 trials, the traffic to CPU rates."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent
TINY = dict(image_size=32, patch_size=8, embed_dim=32, vit_depth=5, num_heads=2, mlp_hidden_dims=[32, 16, 8],
            feature_dim=32, hidden_dim=32, data_dim=3072, timesteps=50, mc_trials=2)


def tiny_config(name: str, dtype: str = "float32") -> dict:
    cfg = json.loads((PORTBENCH / "configs" / f"{name}.json").read_text())
    cfg.update(TINY, dtype=dtype)
    return cfg


def tiny_bench(tmp: Path, dtype: str = "float32"):
    """(spec, base): BENCHMARK.json's spec and a copy of portbench/ under
    ``tmp`` whose configurations and traffic are cut for the CPU."""
    base = tmp / "portbench"
    shutil.copytree(PORTBENCH, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for conf in spec["configs"]:
        name = Path(conf["file"]).stem
        (base / "configs" / f"{name}.json").write_text(json.dumps(tiny_config(name, dtype)))
    for path in (base / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        tr["compare_rows"] = min(tr["compare_rows"], 8)
        if tr["kind"] == "open":
            tr.update(rate_images_per_s=40.0, max_batch=8, pool=256, threads=16)
        path.write_text(json.dumps(tr))
    return spec, base
