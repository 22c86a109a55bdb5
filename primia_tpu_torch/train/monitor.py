"""Live training monitor, the reference's visdom role, with no dependencies.

Port of ``primia_tpu/train/monitor.py``, unchanged. The reference
(``train.py:201-236,443-451``) pushes train/val loss, the Matthews
coefficient and the learning rate to a visdom server. Here the monitor:

* appends every scalar as one JSON line to
  ``model_weights/runs/<exp>.jsonl`` (machine-readable run history), and
* regenerates a self-contained HTML dashboard
  ``model_weights/runs/<exp>.html`` after each update: four
  single-series small multiples (train loss, validation loss, Matthews
  coefficient, learning rate), inline SVG, no external assets.

Chart conventions: one y-axis per chart (never dual-axis), single-series
panels titled instead of legended, thin 2px lines, per-point hover
titles, recessive grid.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Tuple

# categorical slot 1 (validated palette), text + surface tokens
_SERIES = "#2a78d6"
_SURFACE = "#fcfcfb"
_TEXT = "#0b0b0b"
_TEXT2 = "#52514e"
_GRID = "#e7e6e3"

_PANELS = [
    ("train_loss", "Train loss"),
    ("val_loss", "Validation loss"),
    ("val_mcc", "Matthews coefficient (val)"),
    ("lr", "Learning rate"),
]


class Monitor:
    """Append-only scalar logger + static HTML dashboard renderer."""

    def __init__(self, exp_name: str, directory: str = "model_weights/runs",
                 enabled: bool = True, render_html: bool = True):
        self.enabled = enabled
        self.render_html = render_html
        self.exp = exp_name
        self.dir = Path(directory)
        self.series: Dict[str, List[Tuple[float, float]]] = {}
        self._t0 = time.time()
        if enabled:
            self.dir.mkdir(parents=True, exist_ok=True)
            self.jsonl = self.dir / f"{exp_name}.jsonl"
            self.html = self.dir / f"{exp_name}.html"

    def add_scalar(self, series: str, x: float, y: float) -> None:
        if not self.enabled:
            return
        y = float(y)
        x = float(x)
        self.series.setdefault(series, []).append((x, y))
        with self.jsonl.open("a") as f:
            f.write(json.dumps({"t": round(time.time() - self._t0, 3),
                                "series": series, "x": x, "y": y}) + "\n")
        if self.render_html:
            self._render()

    # ----------------------------------------------------------- render

    def _panel_svg(self, title: str, pts: List[Tuple[float, float]],
                   w: int = 420, h: int = 180) -> str:
        pad_l, pad_r, pad_t, pad_b = 52, 12, 30, 26
        iw, ih = w - pad_l - pad_r, h - pad_t - pad_b
        out = [f'<svg viewBox="0 0 {w} {h}" width="{w}" height="{h}" '
               f'role="img" aria-label="{title}">']
        out.append(f'<text x="{pad_l}" y="18" fill="{_TEXT}" font-size="13" '
                   f'font-weight="600">{title}</text>')
        if pts:
            xs = [p[0] for p in pts]
            ys = [p[1] for p in pts]
            x0, x1 = min(xs), max(xs)
            y0, y1 = min(ys), max(ys)
            if x1 == x0:
                x1 = x0 + 1
            if y1 == y0:
                y1 = y0 + (abs(y0) or 1) * 0.1
            sx = lambda x: pad_l + (x - x0) / (x1 - x0) * iw
            sy = lambda y: pad_t + (1 - (y - y0) / (y1 - y0)) * ih
            # 3 recessive horizontal gridlines + y tick labels
            for i in range(3):
                gy = y0 + (y1 - y0) * i / 2
                out.append(f'<line x1="{pad_l}" x2="{w - pad_r}" y1="{sy(gy):.1f}" '
                           f'y2="{sy(gy):.1f}" stroke="{_GRID}" stroke-width="1"/>')
                out.append(f'<text x="{pad_l - 6}" y="{sy(gy) + 4:.1f}" fill="{_TEXT2}" '
                           f'font-size="10" text-anchor="end">{gy:.4g}</text>')
            # x extent labels
            out.append(f'<text x="{pad_l}" y="{h - 8}" fill="{_TEXT2}" '
                       f'font-size="10">{x0:.4g}</text>')
            out.append(f'<text x="{w - pad_r}" y="{h - 8}" fill="{_TEXT2}" '
                       f'font-size="10" text-anchor="end">{x1:.4g}</text>')
            path = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in pts)
            out.append(f'<polyline points="{path}" fill="none" stroke="{_SERIES}" '
                       f'stroke-width="2" stroke-linejoin="round"/>')
            for x, y in pts[-200:]:
                out.append(f'<circle cx="{sx(x):.1f}" cy="{sy(y):.1f}" r="3.5" '
                           f'fill="{_SERIES}"><title>x={x:g}, y={y:.6g}</title></circle>')
        else:
            out.append(f'<text x="{pad_l}" y="{h / 2}" fill="{_TEXT2}" '
                       f'font-size="11">no data yet</text>')
        out.append("</svg>")
        return "".join(out)

    def _render(self) -> None:
        panels = "".join(
            f'<div class="p">{self._panel_svg(title, self.series.get(key, []))}</div>'
            for key, title in _PANELS
        )
        extra = "".join(
            f'<div class="p">{self._panel_svg(k, v)}</div>'
            for k, v in sorted(self.series.items())
            if k not in {k for k, _ in _PANELS}
        )
        doc = (
            "<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{self.exp}</title><style>"
            f"body{{background:{_SURFACE};color:{_TEXT};"
            "font-family:system-ui,sans-serif;margin:24px}}"
            ".g{display:flex;flex-wrap:wrap;gap:16px}"
            f".p{{background:white;border:1px solid {_GRID};border-radius:8px;"
            "padding:8px}}"
            "</style></head><body>"
            f"<h2 style='margin:0 0 4px'>{self.exp}</h2>"
            f"<div style='color:{_TEXT2};font-size:12px;margin-bottom:16px'>"
            "refresh to update &middot; data: "
            f"{self.jsonl.name}</div><div class='g'>{panels}{extra}</div>"
            "</body></html>"
        )
        self.html.write_text(doc)


class NullMonitor(Monitor):
    def __init__(self):
        super().__init__("null", enabled=False)
