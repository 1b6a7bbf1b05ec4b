"""Pipe-plot scene graph → SVG (ref: crates/pipeplot/src/pipeplot.rs,
svg.rs). The SVG layout replicates the reference generator: x normalized
to 750px on the longest pipe, y×3, 12px padding."""

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

DEFAULT_X_SCALE = 750.0
DEFAULT_Y_SCALE = 3.0
DEFAULT_PADDING = 12.0


@dataclass
class Seg:
    width: int
    color: str
    shape: str                      # rect|hline|vline|none|tick|double_arrow
    label: Optional[str] = None     # for tick / double_arrow


@dataclass
class Band:
    pos: int
    width: int
    color: str


@dataclass
class Pipe:
    xpos: int
    ypos: int
    height: int
    segs: List[Seg]
    bands: List[Band]
    outline: bool


@dataclass
class Legend:
    xpos: int
    ypos: int
    height: int
    labels: List[Tuple[str, str]]


@dataclass
class FontConfig:
    family: str = "Roboto Mono"
    weight: str = "bold"
    size: str = "14px"


@dataclass
class PipePlot:
    pipes: List[Pipe]
    legend: Legend
    font: FontConfig = field(default_factory=FontConfig)


def _fmt(x: float) -> str:
    # Rust Display for f64 prints integral values without ".0"
    if x == int(x):
        return str(int(x))
    return repr(x)


class Generator:
    def __init__(self, scale, pad):
        self.scale = scale
        self.pad = pad
        self.lines: List[str] = []

    def to_x(self, x):
        return x * self.scale[0]

    def to_y(self, y):
        return y * self.scale[1]

    def add(self, line):
        self.lines.append(line)

    def generate(self, plot: PipePlot):
        width, height = self.get_dimensions(plot)
        self.add('<?xml version="1.0"?>')
        self.add(f'<svg xmlns="http://www.w3.org/2000/svg" '
                 f'xmlns:xlink="http://www.w3.org/1999/xlink" '
                 f'width="{_fmt(width)}" height="{_fmt(height)}">')
        self.add('<rect width="100%" height="100%" fill="white"/>')
        for pipe in plot.pipes:
            self.plot_pipe(pipe, plot.font)
            if pipe.outline:
                self.plot_outline(pipe)
        self.plot_legend(plot.legend, plot.font)
        self.add("</svg>")
        return "\n".join(self.lines) + "\n"

    def get_dimensions(self, plot: PipePlot):
        width = max((p.xpos + sum(s.width for s in p.segs)
                     for p in plot.pipes), default=0)
        height = plot.legend.ypos + plot.legend.height
        return (self.to_x(width) + 2 * self.pad,
                self.to_y(height) + 2 * self.pad)

    def plot_pipe(self, pipe: Pipe, font: FontConfig):
        x = self.to_x(pipe.xpos) + self.pad
        y = self.to_y(pipe.ypos) + self.pad
        add_highlight = pipe.height > 1
        pipe_height = self.to_y(pipe.height)
        stroke = 1.5 if pipe.height > 1 else 1.0

        x_cur = x
        for seg in pipe.segs:
            dims = (self.to_x(seg.width), pipe_height)
            if seg.shape == "rect":
                self.add_rect((x_cur, y), dims, seg.color, add_highlight)
            elif seg.shape == "hline":
                self.add_hline((x_cur, y), dims, seg.color, stroke)
            elif seg.shape == "tick":
                self.add_tick((x_cur, y), dims, seg.color, seg.label, font)
            elif seg.shape == "double_arrow":
                self.add_double_arrow((x_cur, y), dims, seg.color, stroke,
                                      seg.label)
            x_cur += self.to_x(seg.width)

        x_cur = x
        for seg in pipe.segs:
            dims = (self.to_x(seg.width), pipe_height)
            if seg.shape == "vline":
                self.add_vline((x_cur, y), dims, seg.color)
            x_cur += self.to_x(seg.width)

        for band in pipe.bands:
            beta_x = x + self.to_x(band.pos)
            dims = (self.to_x(1), pipe_height)
            self.add_rect((beta_x, y), dims, band.color, False)

    def plot_outline(self, pipe: Pipe):
        height = self.to_y(pipe.height)
        width = self.to_x(sum(s.width for s in pipe.segs))
        x = self.to_x(pipe.xpos) + self.pad
        y = self.to_y(pipe.ypos) + self.pad
        self.add(f'<rect width="{_fmt(width)}" height="{_fmt(height)}" '
                 f'x="{_fmt(x)}" y="{_fmt(y)}" stroke="#000000" '
                 f'stroke-width="1.5" fill="transparent" />')

    def plot_legend(self, legend: Legend, font: FontConfig):
        base_x = self.to_x(legend.xpos) + self.pad
        base_y = self.to_y(legend.ypos) + self.pad
        height = self.to_y(legend.height)
        x = base_x
        for label, color in legend.labels:
            self.add_rect((x, base_y), (height, height), color, False)
            x += height + 2.0
            self.add(f'<text x="{_fmt(x)}" y="{_fmt(base_y + height - 1.0)}" '
                     f'font-family="{font.family}" '
                     f'font-weight="{font.weight}" '
                     f'font-size="{font.size}" >{label}</text>')
            x += 5.0 * (2 * len(label) + 1)

    def add_rect(self, pos, dims, color, add_highlight):
        x, y = pos
        w, h = dims
        self.add(f'<rect x="{_fmt(x)}" y="{_fmt(y)}" height="{_fmt(h)}" '
                 f'width="{_fmt(w)}" fill="{color}" stroke="{color}" '
                 f'stroke-width="0" opacity="0.9" />')
        if add_highlight:
            self.add(f'<rect x="{_fmt(x)}" y="{_fmt(y + h * 0.18)}" '
                     f'height="{_fmt(h / 3.0)}" width="{_fmt(w)}" '
                     f'fill="#F4EDF2" opacity="0.25" />')

    def add_hline(self, pos, dims, color, stroke):
        x1 = pos[0]
        x2 = pos[0] + dims[0]
        y1 = pos[1] + dims[1] / 2.0
        self.add(f'<line x1="{_fmt(x1)}" y1="{_fmt(y1)}" x2="{_fmt(x2)}" '
                 f'y2="{_fmt(y1)}" stroke="{color}" '
                 f'stroke-width="{_fmt(stroke)}" />')

    def add_vline(self, pos, dims, color):
        x1 = pos[0]
        y1 = pos[1]
        y2 = pos[1] + dims[1]
        stroke_width = min(2.0, self.to_x(1))
        self.add(f'<line x1="{_fmt(x1)}" y1="{_fmt(y1)}" x2="{_fmt(x1)}" '
                 f'y2="{_fmt(y2)}" stroke="{color}" '
                 f'stroke-width="{_fmt(stroke_width)}" />')

    def add_double_arrow(self, pos, dims, color, stroke, label):
        x1 = pos[0]
        x2 = pos[0] + dims[0]
        y1 = pos[1] + dims[1] / 2.0
        self.add(f'<line x1="{_fmt(x1)}" y1="{_fmt(y1)}" x2="{_fmt(x2)}" '
                 f'y2="{_fmt(y1)}" stroke="{color}" '
                 f'stroke-width="{_fmt(stroke)}" />')
        self.add(f'<polygon points="{_fmt(x1)} {_fmt(y1)}, '
                 f'{_fmt(x1 + 5.0)} {_fmt(y1 + 5.0)}, '
                 f'{_fmt(x1 + 5.0)} {_fmt(y1 - 5.0)}"/>')
        self.add(f'<polygon points="{_fmt(x2)} {_fmt(y1)}, '
                 f'{_fmt(x2 - 5.0)} {_fmt(y1 - 5.0)}, '
                 f'{_fmt(x2 - 5.0)} {_fmt(y1 + 5.0)}"/>')
        if label is not None:
            self.add(f'<text x="{_fmt((x1 + x2) / 2.0)}" y="{_fmt(pos[1])}" '
                     f'font-family="monospace" font-weight="bold" '
                     f'text-anchor="middle" font-size="14px" >{label}</text>')

    def add_tick(self, pos, dims, color, label, font):
        x1 = pos[0]
        y1 = pos[1]
        y2 = pos[1] + dims[1]
        self.add(f'<line x1="{_fmt(x1)}" y1="{_fmt(y1)}" x2="{_fmt(x1)}" '
                 f'y2="{_fmt(y2)}" stroke="{color}" stroke-width="1.5" />')
        if label is not None:
            self.add(f'<text x="{_fmt(x1)}" y="{_fmt(y1 - 2.0)}" '
                     f'font-family="{font.family}" '
                     f'font-weight="{font.weight}" '
                     f'font-size="{font.size}" '
                     f'text-anchor="middle" >{label}</text>')


def generate_string(plot: PipePlot) -> str:
    longest = max((sum(s.width for s in p.segs) for p in plot.pipes),
                  default=0)
    x_scale = DEFAULT_X_SCALE / longest if longest else 1.0
    gen = Generator((x_scale, DEFAULT_Y_SCALE), DEFAULT_PADDING)
    return gen.generate(plot)


def generate_image(plot: PipePlot, path: str) -> None:
    # ref: pipeplot/src/image.rs:4-34 — dispatch by extension
    svg = generate_string(plot)
    lower = path.lower()
    if lower.endswith(".svg"):
        with open(path, "w") as fh:
            fh.write(svg)
    elif lower.endswith(".png"):
        _render_png(svg, plot, path)
    elif lower.endswith(".pdf"):
        _render_pdf(svg, plot, path)
    else:
        raise ValueError(f"Unsupported image format: {path}")


def _render_png(svg: str, plot: PipePlot, path: str) -> None:
    try:
        import cairosvg
        cairosvg.svg2png(bytestring=svg.encode(), write_to=path)
        return
    except ImportError:
        pass
    from .raster import rasterize_plot_to_png
    rasterize_plot_to_png(plot, path)


def _render_pdf(svg: str, plot: PipePlot, path: str) -> None:
    # true vector output (no rasterization), ref pipeplot/src/pdf.rs
    from .vector_pdf import write_pdf
    write_pdf(plot, path)
