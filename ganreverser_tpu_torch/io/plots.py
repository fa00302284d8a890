"""Loss-curve charts rendered to PNG — ganreverser_tpu/io/plots.py, vendored
(numpy and PIL only).

The reference live-plots its loss history through the ``display`` browser
server (train_r.lua:204: ``{'epoch','R loss (low)','R loss (avg)',
'R loss (high)'}``). This renders the same rows to a PNG beside the image
grids, with PIL's built-in bitmap font and no plotting library: ``rows[i]
= [x, y1, y2, ...]``, ``labels[0]`` names the x column and ``labels[1:]``
the series.
"""
from __future__ import annotations

import math
import os
from typing import Sequence

import numpy as np

# series palette (dark-on-white; distinguishable at 1px line width)
_COLORS = [(214, 69, 65), (31, 119, 180), (44, 160, 44), (148, 103, 189),
           (255, 127, 14), (23, 190, 207)]
_BG = (255, 255, 255)
_AXIS = (120, 120, 120)
_GRID = (225, 225, 225)
_TEXT = (60, 60, 60)


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1000 or abs(v) < 0.01:
        return f"{v:.2e}"
    return f"{v:.4g}"


def render_chart(rows: Sequence[Sequence[float]], labels: Sequence[str],
                 *, title: str = "", width: int = 640,
                 height: int = 360) -> np.ndarray:
    """Rasterize DISP.plot-style ``rows`` to a (height, width, 3) uint8
    image: auto-scaled axes, gridlines with tick labels, one polyline per
    series, legend. Non-finite samples are skipped (a NaN epoch must not
    blank the whole history — the reference's display does the same by
    simply not drawing the point)."""
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (width, height), _BG)
    draw = ImageDraw.Draw(img)
    n_series = max(0, (max((len(r) for r in rows), default=1) - 1))
    series_labels = list(labels[1:1 + n_series])
    while len(series_labels) < n_series:
        series_labels.append(f"series {len(series_labels) + 1}")

    ml, mr, mt, mb = 56, 12, 22 if title else 12, 30
    x0, y0 = ml, height - mb          # plot origin (bottom-left)
    x1, y1 = width - mr, mt           # top-right
    if title:
        draw.text((ml, 4), title, fill=_TEXT)

    xs = [float(r[0]) for r in rows if len(r) > 0 and math.isfinite(r[0])]
    ys = [float(v) for r in rows for v in r[1:] if math.isfinite(v)]
    if not xs or not ys:
        draw.text((ml, (y0 + y1) // 2), "(no data)", fill=_TEXT)
        draw.line([(x0, y0), (x1, y0)], fill=_AXIS)
        draw.line([(x0, y0), (x0, y1)], fill=_AXIS)
        return np.asarray(img, np.uint8)

    xmin, xmax = min(xs), max(xs)
    ymin, ymax = min(ys), max(ys)
    if xmax == xmin:
        xmin, xmax = xmin - 0.5, xmax + 0.5
    if ymax == ymin:
        ymin, ymax = ymin - 0.5, ymax + 0.5
    ypad = 0.05 * (ymax - ymin)
    ymin, ymax = ymin - ypad, ymax + ypad

    def px(x: float) -> float:
        return x0 + (x - xmin) / (xmax - xmin) * (x1 - x0)

    def py(y: float) -> float:
        return y0 + (y - ymin) / (ymax - ymin) * (y1 - y0)

    # gridlines + ticks (5 y, up to 6 x)
    for i in range(5):
        yv = ymin + (ymax - ymin) * i / 4
        yy = py(yv)
        draw.line([(x0, yy), (x1, yy)], fill=_GRID)
        draw.text((4, yy - 5), _fmt(yv), fill=_TEXT)
    n_xt = min(6, max(2, len(set(xs))))
    for i in range(n_xt):
        xv = xmin + (xmax - xmin) * i / (n_xt - 1)
        xx = px(xv)
        draw.line([(xx, y0), (xx, y1)], fill=_GRID)
        draw.text((min(xx - 6, width - 30), y0 + 4), _fmt(xv), fill=_TEXT)
    if labels:
        draw.text((width - mr - 6 * len(str(labels[0])) - 8, height - 12),
                  str(labels[0]), fill=_TEXT)

    # axes on top of the grid
    draw.line([(x0, y0), (x1, y0)], fill=_AXIS)
    draw.line([(x0, y0), (x0, y1)], fill=_AXIS)

    # series polylines. A non-finite sample BREAKS the line (a visible
    # gap, like the reference display's undrawn point) — connecting the
    # neighbours through it would fabricate a segment where data is NaN.
    for s in range(n_series):
        color = _COLORS[s % len(_COLORS)]
        segments: list = [[]]
        for r in rows:
            if (len(r) > 1 + s and math.isfinite(r[0])
                    and math.isfinite(r[1 + s])):
                segments[-1].append((px(float(r[0])), py(float(r[1 + s]))))
            elif segments[-1]:
                segments.append([])
        for pts in segments:
            if len(pts) == 1:
                cx, cy = pts[0]
                draw.ellipse([cx - 2, cy - 2, cx + 2, cy + 2], fill=color)
            elif pts:
                draw.line(pts, fill=color, width=1)

    # legend, top-right inside the plot area
    ly = y1 + 4
    for s, lab in enumerate(series_labels):
        color = _COLORS[s % len(_COLORS)]
        lx = x1 - 150
        draw.line([(lx, ly + 5), (lx + 16, ly + 5)], fill=color, width=2)
        draw.text((lx + 22, ly), str(lab), fill=_TEXT)
        ly += 12

    return np.asarray(img, np.uint8)


def save_chart(path: str, rows: Sequence[Sequence[float]],
               labels: Sequence[str], *, title: str = "",
               width: int = 640, height: int = 360) -> str:
    """Render and write the chart PNG (parents created). Returns ``path``.
    Empty ``rows`` write the empty-axes '(no data)' chart, so the artifact
    always exists once training starts."""
    from PIL import Image
    arr = render_chart(rows, labels, title=title, width=width, height=height)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(arr).save(path)
    return path
