"""Run-local metrics logging, the CLI error decorator, and profiling."""
from implicit_image_tpu_torch.utils.logger import MetricsLogger, catch_error_decorator
from implicit_image_tpu_torch.utils.profiling import annotate, trace, wall

__all__ = ["MetricsLogger", "catch_error_decorator", "annotate", "trace", "wall"]
