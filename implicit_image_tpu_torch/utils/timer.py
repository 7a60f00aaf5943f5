"""perf_counter context manager (counterpart of
implicit_image_tpu/utils/timer.py; reference utils/timer.py:9-13)."""
from __future__ import annotations

from contextlib import contextmanager
from time import perf_counter

__all__ = ["catchtime"]


@contextmanager
def catchtime():
    """with catchtime() as t: ...; elapsed = t()"""
    start = perf_counter()
    yield lambda: perf_counter() - start
