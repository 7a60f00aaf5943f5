"""Run-local metrics sink (counterpart of implicit_image_tpu/utils/logger.py):
`<run_dir>/metrics.jsonl` (one JSON object per logged step) and
`<run_dir>/summary.json`, in the same format as the JAX package's, plus a
log line per step, and train.watch's `<run_dir>/histograms.jsonl`. The
optional W&B sink is not ported."""
from __future__ import annotations

import functools
import json
import logging
import sys
import traceback
from pathlib import Path
from typing import Optional

log = logging.getLogger("implicit_image_tpu_torch")

__all__ = ["MetricsLogger", "catch_error_decorator"]


def _clean(metrics: dict) -> dict:
    return {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}


class MetricsLogger:
    def __init__(self, run_dir: Optional[str] = None, use: bool = True):
        self.use = use
        self.run_dir = Path(run_dir) if run_dir else None
        self._fh = None
        if use and self.run_dir is not None:
            self.run_dir.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.run_dir / "metrics.jsonl", "a")

    def log(self, step: int, metrics: dict, prefix: str = "Train"):
        if not self.use:
            return
        clean = _clean(metrics)
        line = " | ".join(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                          for k, v in clean.items())
        log.info("%s step %d | %s", prefix, step, line)
        if self._fh is not None:
            self._fh.write(json.dumps({"step": step, "prefix": prefix, **clean}) + "\n")
            self._fh.flush()

    def histogram(self, step: int, tensors: dict, bins: int = 64, prefix: str = "watch"):
        """train.watch's sink: one `histograms.jsonl` row per call, the JAX
        package's format: per tensor its `bins`-bin histogram counts and
        the range (numpy.histogram)."""
        if not self.use:
            return
        import numpy as np

        out = {}
        for name, arr in tensors.items():
            counts, edges = np.histogram(np.asarray(arr).ravel(), bins=bins)
            out[name] = {"counts": counts.tolist(), "min": float(edges[0]),
                         "max": float(edges[-1])}
        if self.run_dir is not None:
            with open(self.run_dir / "histograms.jsonl", "a") as fh:
                fh.write(json.dumps({"step": step, "prefix": prefix, "histograms": out}) + "\n")

    def summary(self, metrics: dict):
        if not self.use or self.run_dir is None:
            return
        path = self.run_dir / "summary.json"
        existing = json.loads(path.read_text()) if path.exists() else {}
        existing.update(_clean(metrics))
        path.write_text(json.dumps(existing, indent=2))

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def catch_error_decorator(fn):
    """CLI boundary: log the traceback and exit 1 so schedulers mark the job
    failed."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except SystemExit:
            raise
        except Exception:
            logging.error(traceback.format_exc())
            sys.exit(1)

    return wrapped
