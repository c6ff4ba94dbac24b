"""Observability: the TensorBoard logger and the synthesis report files."""

from .logger import Logger
from .visualizations import generate_html_report, save_bar_plot

__all__ = ["Logger", "generate_html_report", "save_bar_plot"]
