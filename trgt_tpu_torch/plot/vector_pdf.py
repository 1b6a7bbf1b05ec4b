"""True vector PDF rendering of a PipePlot scene.

Replaces the reference's svg2pdf path (ref: crates/pipeplot/src/pdf.rs)
without external dependencies: a hand-written PDF 1.4 with one page
whose content stream mirrors the SVG generator's drawing calls (rects,
lines, arrow polygons, text).

Text uses an EMBEDDED monospace TrueType font when one is available on
the system (DejaVuSansMono-Bold — the stand-in for the reference's
bundled RobotoMono-Bold, crates/pipeplot/src/common.rs:3-10), with
metrics read from the font's head/hhea/hmtx tables so advance widths
and centering are exact. The font program is embedded whole (FontFile2,
FlateDecode) rather than subset — spec-compliant and self-contained at
the cost of ~0.2MB per file. Without a TTF on disk it falls back to the
base-14 Courier-Bold (600/1000-unit glyphs, no embedding needed).
"""

import os
import struct
import zlib
from typing import List, Optional, Tuple

from .pipeplot import (DEFAULT_PADDING, DEFAULT_X_SCALE, DEFAULT_Y_SCALE,
                       FontConfig, Pipe, PipePlot)

_COURIER_W = 0.6        # glyph advance as a fraction of font size

_TTF_CANDIDATES = [
    "/usr/share/fonts/truetype/dejavu/DejaVuSansMono-Bold.ttf",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "fonts", "DejaVuSansMono-Bold.ttf"),
]


class _TtfMetrics:
    """Minimal TrueType metric reader (head/hhea/hmtx tables only —
    enough for a fixed-pitch font's PDF FontDescriptor + Widths)."""

    def __init__(self, data: bytes):
        self.data = data
        (_ver, num_tables) = struct.unpack_from(">IH", data, 0)
        tables = {}
        for i in range(num_tables):
            tag, _chk, off, length = struct.unpack_from(
                ">4sIII", data, 12 + 16 * i)
            tables[tag] = (off, length)
        head_off = tables[b"head"][0]
        self.units_per_em = struct.unpack_from(">H", data,
                                               head_off + 18)[0]
        xmin, ymin, xmax, ymax = struct.unpack_from(">hhhh", data,
                                                    head_off + 36)
        self.bbox = (xmin, ymin, xmax, ymax)
        hhea_off = tables[b"hhea"][0]
        self.ascent, self.descent = struct.unpack_from(">hh", data,
                                                       hhea_off + 4)
        hmtx_off = tables[b"hmtx"][0]
        # fixed pitch: every glyph shares the first advance width
        self.advance = struct.unpack_from(">H", data, hmtx_off)[0]

    def scaled(self, v: float) -> int:
        return round(v * 1000.0 / self.units_per_em)


def _load_ttf() -> Optional[Tuple[bytes, "_TtfMetrics"]]:
    for path in _TTF_CANDIDATES:
        try:
            with open(path, "rb") as fh:
                data = fh.read()
            return data, _TtfMetrics(data)
        except Exception:
            continue
    return None


def _rgb(color: str) -> Tuple[float, float, float]:
    c = color.strip()
    named = {"black": "#000000", "white": "#ffffff", "gray": "#7e7f7f",
             "grey": "#7e7f7f", "transparent": None}
    if c.lower() in named:
        c = named[c.lower()]
        if c is None:
            return None
    if c.startswith("#") and len(c) == 7:
        return (int(c[1:3], 16) / 255.0, int(c[3:5], 16) / 255.0,
                int(c[5:7], 16) / 255.0)
    return (0.0, 0.0, 0.0)


def _f(x: float) -> str:
    return f"{x:.2f}".rstrip("0").rstrip(".") or "0"


class _Content:
    """Content-stream builder (PDF user space, y flipped from SVG)."""

    def __init__(self, height: float, advance: float = _COURIER_W):
        self.h = height
        self.advance = advance        # glyph advance / font size
        self.ops: List[str] = []

    def _y(self, y: float) -> float:
        return self.h - y

    def rect(self, x, y, w, h, color, opacity=1.0, stroke=None,
             stroke_width=0.0):
        fill = _rgb(color) if color else None
        self.ops.append("q")
        if opacity < 1.0:
            self.ops.append(f"/GS{int(opacity * 100)} gs")
        if fill is not None:
            r, g, b = fill
            self.ops.append(f"{_f(r)} {_f(g)} {_f(b)} rg")
        stroke_rgb = _rgb(stroke) if stroke is not None else None
        if stroke_rgb is not None:
            sr, sg, sb = stroke_rgb
            self.ops.append(f"{_f(sr)} {_f(sg)} {_f(sb)} RG")
            self.ops.append(f"{_f(stroke_width)} w")
        if fill is None and stroke_rgb is None:  # fully transparent rect
            self.ops.append("Q")
            return
        self.ops.append(f"{_f(x)} {_f(self._y(y) - h)} {_f(w)} {_f(h)} re")
        if fill is not None and stroke_rgb is not None:
            self.ops.append("B")
        elif stroke_rgb is not None:
            self.ops.append("S")
        else:
            self.ops.append("f")
        self.ops.append("Q")

    def line(self, x1, y1, x2, y2, color, width):
        rgb = _rgb(color)
        if rgb is None:                          # transparent stroke
            return
        r, g, b = rgb
        self.ops.append("q")
        self.ops.append(f"{_f(r)} {_f(g)} {_f(b)} RG")
        self.ops.append(f"{_f(width)} w")
        self.ops.append(f"{_f(x1)} {_f(self._y(y1))} m "
                        f"{_f(x2)} {_f(self._y(y2))} l S")
        self.ops.append("Q")

    def polygon(self, points, color="#000000"):
        rgb = _rgb(color)
        if rgb is None:                          # transparent fill
            return
        r, g, b = rgb
        self.ops.append("q")
        self.ops.append(f"{_f(r)} {_f(g)} {_f(b)} rg")
        (x0, y0), *rest = points
        self.ops.append(f"{_f(x0)} {_f(self._y(y0))} m")
        for x, y in rest:
            self.ops.append(f"{_f(x)} {_f(self._y(y))} l")
        self.ops.append("h f Q")

    def text(self, x, y, s, size, anchor="start"):
        width = len(s) * size * self.advance
        if anchor == "middle":
            x -= width / 2.0
        esc = s.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")
        self.ops.append("q BT")
        self.ops.append(f"/F1 {_f(size)} Tf")
        self.ops.append(f"{_f(x)} {_f(self._y(y))} Td")
        self.ops.append(f"({esc}) Tj")
        self.ops.append("ET Q")

    def stream(self) -> bytes:
        return "\n".join(self.ops).encode("latin-1")


class _VectorGen:
    """Mirror of pipeplot.Generator targeting the PDF content stream."""

    def __init__(self, scale, pad, advance: float = _COURIER_W):
        self.scale = scale
        self.pad = pad
        self.advance = advance

    def to_x(self, x):
        return x * self.scale[0]

    def to_y(self, y):
        return y * self.scale[1]

    def dimensions(self, plot: PipePlot):
        width = max((p.xpos + sum(s.width for s in p.segs)
                     for p in plot.pipes), default=0)
        height = plot.legend.ypos + plot.legend.height
        return (self.to_x(width) + 2 * self.pad,
                self.to_y(height) + 2 * self.pad)

    def render(self, plot: PipePlot) -> Tuple[bytes, float, float]:
        w, h = self.dimensions(plot)
        c = _Content(h, advance=self.advance)
        c.rect(0, 0, w, h, "#ffffff")
        font_size = float(str(plot.font.size).replace("px", ""))
        for pipe in plot.pipes:
            self._pipe(c, pipe, plot.font, font_size)
            if pipe.outline:
                height = self.to_y(pipe.height)
                width = self.to_x(sum(s.width for s in pipe.segs))
                x = self.to_x(pipe.xpos) + self.pad
                y = self.to_y(pipe.ypos) + self.pad
                c.rect(x, y, width, height, None, stroke="#000000",
                       stroke_width=1.5)
        self._legend(c, plot.legend, font_size)
        return c.stream(), w, h

    def _pipe(self, c: _Content, pipe: Pipe, font: FontConfig,
              font_size: float):
        x = self.to_x(pipe.xpos) + self.pad
        y = self.to_y(pipe.ypos) + self.pad
        add_highlight = pipe.height > 1
        pipe_height = self.to_y(pipe.height)
        stroke = 1.5 if pipe.height > 1 else 1.0

        x_cur = x
        for seg in pipe.segs:
            w = self.to_x(seg.width)
            if seg.shape == "rect":
                c.rect(x_cur, y, w, pipe_height, seg.color, opacity=0.9)
                if add_highlight:
                    c.rect(x_cur, y + pipe_height * 0.18, w,
                           pipe_height / 3.0, "#F4EDF2", opacity=0.25)
            elif seg.shape == "hline":
                ym = y + pipe_height / 2.0
                c.line(x_cur, ym, x_cur + w, ym, seg.color, stroke)
            elif seg.shape == "tick":
                c.line(x_cur, y, x_cur, y + pipe_height, seg.color, 1.5)
                if seg.label is not None:
                    c.text(x_cur, y - 2.0, seg.label, font_size,
                           anchor="middle")
            elif seg.shape == "double_arrow":
                ym = y + pipe_height / 2.0
                c.line(x_cur, ym, x_cur + w, ym, seg.color, stroke)
                c.polygon([(x_cur, ym), (x_cur + 5.0, ym + 5.0),
                           (x_cur + 5.0, ym - 5.0)])
                c.polygon([(x_cur + w, ym), (x_cur + w - 5.0, ym - 5.0),
                           (x_cur + w - 5.0, ym + 5.0)])
                if seg.label is not None:
                    c.text((2 * x_cur + w) / 2.0, y, seg.label, 14.0,
                           anchor="middle")
            x_cur += w

        x_cur = x
        for seg in pipe.segs:
            if seg.shape == "vline":
                c.line(x_cur, y, x_cur, y + pipe_height, seg.color,
                       min(2.0, self.to_x(1)))
            x_cur += self.to_x(seg.width)

        for band in pipe.bands:
            c.rect(x + self.to_x(band.pos), y, self.to_x(1), pipe_height,
                   band.color)

    def _legend(self, c: _Content, legend, font_size: float):
        base_x = self.to_x(legend.xpos) + self.pad
        base_y = self.to_y(legend.ypos) + self.pad
        height = self.to_y(legend.height)
        x = base_x
        for label, color in legend.labels:
            c.rect(x, base_y, height, height, color)
            x += height + 2.0
            c.text(x, base_y + height - 1.0, label, font_size)
            x += 5.0 * (2 * len(label) + 1)


def write_pdf(plot: PipePlot, path: str) -> None:
    longest = max((sum(s.width for s in p.segs) for p in plot.pipes),
                  default=0)
    x_scale = DEFAULT_X_SCALE / longest if longest else 1.0
    ttf = _load_ttf()
    advance = (ttf[1].advance / ttf[1].units_per_em) if ttf \
        else _COURIER_W
    gen = _VectorGen((x_scale, DEFAULT_Y_SCALE), DEFAULT_PADDING,
                     advance=advance)
    stream, w, h = gen.render(plot)
    compressed = zlib.compress(stream, 6)

    objects: List[bytes] = []
    objects.append(b"<< /Type /Catalog /Pages 2 0 R >>")
    objects.append(b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>")
    objects.append(
        (f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {_f(w)} {_f(h)}] "
         f"/Contents 4 0 R /Resources << /Font << /F1 5 0 R >> "
         f"/ExtGState << /GS90 6 0 R /GS25 7 0 R >> >> >>")
        .encode("latin-1"))
    objects.append(
        (f"<< /Length {len(compressed)} /Filter /FlateDecode >>\n"
         ).encode("latin-1") + b"stream\n" + compressed + b"\nendstream")
    if ttf is None:
        objects.append(b"<< /Type /Font /Subtype /Type1 "
                       b"/BaseFont /Courier-Bold >>")
    else:
        data, m = ttf
        width_1000 = m.scaled(m.advance)
        widths = " ".join([str(width_1000)] * (255 - 32 + 1))
        objects.append(
            (f"<< /Type /Font /Subtype /TrueType "
             f"/BaseFont /DejaVuSansMono-Bold /FirstChar 32 "
             f"/LastChar 255 /Widths [{widths}] "
             f"/FontDescriptor 8 0 R /Encoding /WinAnsiEncoding >>")
            .encode("latin-1"))
    objects.append(b"<< /Type /ExtGState /ca 0.9 /CA 0.9 >>")
    objects.append(b"<< /Type /ExtGState /ca 0.25 /CA 0.25 >>")
    if ttf is not None:
        data, m = ttf
        xmin, ymin, xmax, ymax = (m.scaled(v) for v in m.bbox)
        # Flags: bit 1 FixedPitch + bit 6 Nonsymbolic = 1 + 32
        objects.append(
            (f"<< /Type /FontDescriptor /FontName /DejaVuSansMono-Bold "
             f"/Flags 33 /FontBBox [{xmin} {ymin} {xmax} {ymax}] "
             f"/ItalicAngle 0 /Ascent {m.scaled(m.ascent)} "
             f"/Descent {m.scaled(m.descent)} /CapHeight "
             f"{m.scaled(m.ascent)} /StemV 120 /FontFile2 9 0 R >>")
            .encode("latin-1"))
        font_z = zlib.compress(data, 6)
        objects.append(
            (f"<< /Length {len(font_z)} /Length1 {len(data)} "
             f"/Filter /FlateDecode >>\n").encode("latin-1")
            + b"stream\n" + font_z + b"\nendstream")

    out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
    offsets = [0]
    for i, obj in enumerate(objects, start=1):
        offsets.append(len(out))
        out += f"{i} 0 obj\n".encode() + obj + b"\nendobj\n"
    xref_pos = len(out)
    out += f"xref\n0 {len(objects) + 1}\n".encode()
    out += b"0000000000 65535 f \n"
    for off in offsets[1:]:
        out += f"{off:010d} 00000 n \n".encode()
    out += (f"trailer\n<< /Size {len(objects) + 1} /Root 1 0 R >>\n"
            f"startxref\n{xref_pos}\n%%EOF\n").encode()
    with open(path, "wb") as fh:
        fh.write(bytes(out))
