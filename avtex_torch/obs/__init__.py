"""Observability: meters, the TensorBoard logger, the synthesis report
files, ``trace``, a torch.profiler block writing a Chrome trace, and
``spans``, the program's own spans recorded in memory while a profiler
runs (``avtex_torch.obs.spans``)."""

from . import spans
from .logger import Logger
from .meters import AverageMeter
from .profiler import trace
from .visualizations import generate_html_report, overlay_cam, save_bar_plot

__all__ = ["AverageMeter", "Logger", "generate_html_report", "overlay_cam",
           "save_bar_plot", "spans", "trace"]
