"""Profiling (counterpart of implicit_image_tpu/utils/profiling.py), on
torch.profiler:

  * `trace(dir)`     — a torch.profiler trace of the block (CPU activity,
                       and CUDA kernels when a card is present) written as a
                       Chrome trace to `<dir>/trace.json` (chrome://tracing,
                       Perfetto); `profile=True` in compress.main wraps the
                       fit in it;
  * `annotate(name)` — a named span in that trace (record_function) and, on
                       a card, an NVTX range;
  * `wall(label)`    — a perf_counter span logged to the package logger.

The JAX package's `cost_analysis` is XLA's compiler estimate of a compiled
program and has no counterpart here (ROADMAP.md, "Not to port").
"""
from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path

import torch

log = logging.getLogger("implicit_image_tpu_torch")

__all__ = ["trace", "annotate", "wall"]

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; on exit write `<log_dir>/trace.json`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / TRACE_FILE))
    log.info("profile: trace written to %s", out / TRACE_FILE)


@contextlib.contextmanager
def annotate(name: str):
    """A named span (nestable) in a torch.profiler trace and, on a card, an
    NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def wall(label: str):
    """Log the block's wall seconds as `label: x s`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        log.info("%s: %.3f s", label, time.perf_counter() - t0)
