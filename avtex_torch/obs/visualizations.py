"""Synthesis outputs beside the videos: per-step bar plots and the HTML
report (the port's copy of avtex/obs/visualizations.py:35-77).
matplotlib is imported at use."""

from __future__ import annotations

import html
import os
from typing import Dict, Optional, Sequence

import numpy as np


def save_bar_plot(values: Sequence[float], path: str, title: str,
                  xlabel: str = "step") -> str:
    """Bar PNG of a per-step statistic (entropy / non-zero counts)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig = plt.figure(figsize=(10, 3))
    ax = fig.add_subplot(1, 1, 1)
    ax.bar(np.arange(len(values)), np.asarray(values, dtype=float))
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def generate_html_report(out_path: str, videos: Dict[str, str],
                         stats: Optional[Dict[str, float]] = None,
                         title: str = "avtex results") -> str:
    """Write a small gallery page linking the result videos, with a table
    of ``stats``."""
    rows = []
    for name, path in videos.items():
        rows.append(
            f"<div class='item'><h3>{html.escape(name)}</h3>"
            f"<video controls width='480' src='{html.escape(path)}'>"
            f"</video></div>")
    stat_rows = ""
    if stats:
        cells = "".join(f"<tr><td>{html.escape(k)}</td><td>{v}</td></tr>"
                        for k, v in stats.items())
        stat_rows = f"<table border='1'>{cells}</table>"
    doc = (f"<!doctype html><html><head><meta charset='utf-8'>"
           f"<title>{html.escape(title)}</title></head>"
           f"<body><h1>{html.escape(title)}</h1>{stat_rows}"
           f"{''.join(rows)}</body></html>")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(doc)
    return out_path
