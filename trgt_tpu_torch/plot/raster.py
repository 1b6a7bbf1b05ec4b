"""PNG rasterization of a PipePlot scene via Pillow (replaces
resvg/tiny-skia, ref: crates/pipeplot/src/png.rs); PDF is vector_pdf.py's.

Renders the scene graph directly (same geometry as the SVG generator) so
no SVG parser is needed."""

from typing import Tuple

from .pipeplot import (DEFAULT_PADDING, DEFAULT_X_SCALE, DEFAULT_Y_SCALE,
                       PipePlot)

SUPERSAMPLE = 2


def _color(c: str) -> Tuple[int, int, int]:
    c = c.lstrip("#")
    if len(c) == 6:
        return tuple(int(c[i:i + 2], 16) for i in (0, 2, 4))
    return (0, 0, 0)


def _render(plot: PipePlot):
    from PIL import Image, ImageDraw

    longest = max((sum(s.width for s in p.segs) for p in plot.pipes),
                  default=0)
    x_scale = (DEFAULT_X_SCALE / longest if longest else 1.0) * SUPERSAMPLE
    y_scale = DEFAULT_Y_SCALE * SUPERSAMPLE
    pad = DEFAULT_PADDING * SUPERSAMPLE

    def to_x(x):
        return x * x_scale

    def to_y(y):
        return y * y_scale

    width = max((p.xpos + sum(s.width for s in p.segs)
                 for p in plot.pipes), default=0)
    height = plot.legend.ypos + plot.legend.height
    W = int(to_x(width) + 2 * pad) + 1
    H = int(to_y(height) + 2 * pad) + 1
    img = Image.new("RGB", (max(W, 1), max(H, 1)), "white")
    draw = ImageDraw.Draw(img, "RGBA")

    for pipe in plot.pipes:
        x = to_x(pipe.xpos) + pad
        y = to_y(pipe.ypos) + pad
        ph = to_y(pipe.height)
        x_cur = x
        for seg in pipe.segs:
            w = to_x(seg.width)
            color = _color(seg.color)
            if seg.shape == "rect":
                draw.rectangle([x_cur, y, x_cur + w, y + ph],
                               fill=color + (230,))
            elif seg.shape in ("hline", "double_arrow"):
                ym = y + ph / 2
                draw.line([x_cur, ym, x_cur + w, ym], fill=color,
                          width=SUPERSAMPLE)
            x_cur += w
        x_cur = x
        for seg in pipe.segs:
            w = to_x(seg.width)
            if seg.shape == "vline":
                draw.line([x_cur, y, x_cur, y + ph],
                          fill=_color(seg.color), width=SUPERSAMPLE)
            x_cur += w
        for band in pipe.bands:
            bx = x + to_x(band.pos)
            draw.rectangle([bx, y, bx + to_x(1), y + ph],
                           fill=_color(band.color) + (230,))
        if pipe.outline:
            total_w = to_x(sum(s.width for s in pipe.segs))
            draw.rectangle([x, y, x + total_w, y + ph], outline=(0, 0, 0),
                           width=SUPERSAMPLE)

    # legend
    base_x = to_x(plot.legend.xpos) + pad
    base_y = to_y(plot.legend.ypos) + pad
    lh = to_y(plot.legend.height)
    lx = base_x
    for label, color in plot.legend.labels:
        draw.rectangle([lx, base_y, lx + lh, base_y + lh],
                       fill=_color(color) + (230,))
        lx += lh + 2
        draw.text((lx, base_y), label, fill=(0, 0, 0))
        lx += 5.0 * (2 * len(label) + 1) * SUPERSAMPLE

    if SUPERSAMPLE > 1:
        img = img.resize((max(W // SUPERSAMPLE, 1),
                          max(H // SUPERSAMPLE, 1)))
    return img


def rasterize_plot_to_png(plot: PipePlot, path: str) -> None:
    _render(plot).save(path, "PNG")
