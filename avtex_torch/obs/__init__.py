"""Observability: meters, the TensorBoard logger, the synthesis report
files and ``trace``, a torch.profiler block writing a Chrome trace."""

from .logger import Logger
from .meters import AverageMeter, Timer
from .profiler import trace
from .visualizations import generate_html_report, overlay_cam, save_bar_plot

__all__ = ["AverageMeter", "Logger", "Timer", "generate_html_report",
           "overlay_cam", "save_bar_plot", "trace"]
