"""Local run-store reader (a copy of implicit_image_tpu/visualize/runs.py,
which the port cannot import) — the replacement for the reference's W&B API.

The reference's analysis scripts call `wandb.Api().runs(...)` and filter by
config (e.g. rate_distortion.py:159-168). Here a "run" is a directory
under outputs/ containing summary.json (+ metrics.jsonl, + the config echo
config.json when present); `collect_runs` walks the tree and yields
(run_dir, summary dict) pairs with simple key filters. `optional_import`
(the port's own) imports a plot's optional package or names it in the error.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["load_run", "collect_runs", "optional_import"]


def load_run(run_dir) -> Dict:
    run_dir = Path(run_dir)
    out: Dict = {"dir": str(run_dir)}
    summary = run_dir / "summary.json"
    if summary.exists():
        out.update(json.loads(summary.read_text()))
    metrics = run_dir / "metrics.jsonl"
    if metrics.exists():
        out["history"] = [
            json.loads(line) for line in metrics.read_text().splitlines() if line
        ]
    config = run_dir / "config.json"
    if config.exists():
        out["config"] = json.loads(config.read_text())
    return out


def collect_runs(
    root="outputs", require: Optional[List[str]] = None
) -> List[Dict]:
    """All runs under `root` that carry the required summary keys."""
    require = require or []
    runs = []
    root = Path(root)
    if not root.exists():
        return runs
    for summary in sorted(root.rglob("summary.json")):
        run = load_run(summary.parent)
        if all(k in run for k in require):
            runs.append(run)
    return runs


def optional_import(name: str, what: str, without: str):
    """Import the optional package `name` (cv2, matplotlib) or raise an
    ImportError that names it; `without` says what runs without it."""
    import importlib

    try:
        return importlib.import_module(name)
    except ImportError as e:
        raise ImportError(f"{what} needs the {name!r} package, which is not installed "
                          f"here; {without} runs without it") from e
