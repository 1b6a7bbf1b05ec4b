"""Plot params and colors (ref: src/trvz/params.rs)."""

from dataclasses import dataclass
from typing import Dict, List

from .align import SegType

COLORS = {
    "purple": "#814ED1",
    "blue": "#1383C6",
    "orange": "#E16A2C",
    "teal": "#009CA2",
    "gray": "#7E7F7F",
    "lightgray": "#D1D1D1",
    "black": "#000000",
    "pink": "#ED3981",
    "yellow": "#EFCD17",
    "green": "#009D4E",
    "red": "#E3371E",
    "khaki": "#F0E68C",
    "palered": "#FF4858",
    "paleblue": "#46B2E8",
}

TR_COLOR_CYCLE = ["blue", "purple", "orange", "pink", "yellow", "green",
                  "red", "khaki", "palered", "paleblue"]

ColorMap = Dict[SegType, str]


@dataclass
class PlotParams:
    colors: ColorMap
    pipe_height: int
    pipe_pad: int


def gradient(value: float) -> str:
    # ref: params.rs:110-118 — blue (0,73,255) → red (255,0,0)
    blue = (0, 73, 255)
    red = (255, 0, 0)
    mix = tuple(round(b * (1.0 - value) + r * value)
                for b, r in zip(blue, red))
    return "#{:02X}{:02X}{:02X}".format(*mix)


def pick_colors(motifs: List[str]) -> ColorMap:
    colors: ColorMap = {("lf",): COLORS["teal"], ("rf",): COLORS["teal"]}
    for index in range(len(motifs)):
        colors[("tr", index)] = COLORS[
            TR_COLOR_CYCLE[index % len(TR_COLOR_CYCLE)]]
    colors[("tr", len(motifs))] = COLORS["lightgray"]
    return colors


def get_meth_colors(motifs: List[str]) -> ColorMap:
    colors: ColorMap = {("lf",): COLORS["teal"], ("rf",): COLORS["teal"]}
    for index in range(len(motifs) + 1):
        colors[("tr", index)] = COLORS["lightgray"]
    return colors


def pick_params(motifs: List[str], is_squished: bool) -> PlotParams:
    colors = pick_colors(motifs)
    if not is_squished:
        return PlotParams(colors=colors, pipe_height=4, pipe_pad=1)
    return PlotParams(colors=colors, pipe_height=1, pipe_pad=0)
