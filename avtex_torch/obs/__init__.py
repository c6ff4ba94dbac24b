"""Observability: meters, the TensorBoard logger and the synthesis report
files."""

from .logger import Logger
from .meters import AverageMeter, Timer
from .visualizations import generate_html_report, overlay_cam, save_bar_plot

__all__ = ["AverageMeter", "Logger", "Timer", "generate_html_report",
           "overlay_cam", "save_bar_plot"]
