"""Error-catching decorator (counterpart of
implicit_image_tpu/utils/catch_error.py; reference utils/catch_error.py:6-22).

Logs the traceback and exits 1 so batch schedulers mark the job failed.
"""
from __future__ import annotations

import functools
import logging
import sys
import traceback

__all__ = ["catch_error_decorator"]


def catch_error_decorator(fn):
    """CLI boundary: log the traceback and exit 1 so schedulers mark the job
    failed; SystemExit passes through."""

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
