"""Run-local metrics logging, the CLI error decorator, the timer and
profiling."""
from implicit_image_tpu_torch.utils.catch_error import catch_error_decorator
from implicit_image_tpu_torch.utils.logger import MetricsLogger
from implicit_image_tpu_torch.utils.profiling import annotate, trace, wall
from implicit_image_tpu_torch.utils.timer import catchtime

__all__ = ["catchtime", "catch_error_decorator", "MetricsLogger", "annotate", "trace", "wall"]
