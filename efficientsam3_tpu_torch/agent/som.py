"""Copy of efficientsam3_tpu/agent/som.py.

Set-of-Mark (SoM) drawing helpers: numbered, color-coded instance
overlays an MLLM can point at by index.

Mirrors the drawing surface of the reference agent helpers
(sam3/sam3/agent/helpers/som_utils.py — palette + farthest-color pick,
draw_box/draw_mask/draw_text; helpers/visualizer.py — overlay_instances
with numeric label_mode) with a pure-numpy rasterizer instead of the
reference's cv2/matplotlib stack: the agent loop runs in servers and
tests where neither is a wanted dependency, and uint8 numpy arrays are
what the rest of this framework's host-side code speaks.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

# 20 saturated, mutually distant colors (named so an LLM can refer to
# them in words; same design point as the reference's approved-color
# table, som_utils.py DEFAULT_COLOR_HEX_TO_NAME).
PALETTE: List[Tuple[Tuple[int, int, int], str]] = [
    ((255, 255, 0), "yellow"),
    ((0, 255, 0), "lime"),
    ((0, 255, 255), "cyan"),
    ((255, 0, 255), "magenta"),
    ((255, 0, 0), "red"),
    ((255, 127, 0), "orange"),
    ((127, 255, 0), "chartreuse"),
    ((0, 255, 127), "spring green"),
    ((255, 0, 127), "rose"),
    ((127, 0, 255), "violet"),
    ((192, 255, 0), "electric lime"),
    ((255, 192, 0), "vivid orange"),
    ((0, 255, 192), "turquoise"),
    ((192, 0, 255), "bright violet"),
    ((255, 0, 192), "bright pink"),
    ((255, 64, 0), "fiery orange"),
    ((64, 255, 0), "bright chartreuse"),
    ((0, 255, 64), "malachite"),
    ((64, 0, 255), "deep violet"),
    ((255, 0, 64), "hot pink"),
]


def color_name(rgb: Tuple[int, int, int]) -> Optional[str]:
    for c, n in PALETTE:
        if tuple(rgb) == c:
            return n
    return None


def rgb_to_hex(rgb: Sequence[int]) -> str:
    return "#%02x%02x%02x" % tuple(int(c) for c in rgb)


@dataclasses.dataclass
class ColorPalette:
    colors: List[Tuple[int, int, int]]

    @classmethod
    def default(cls) -> "ColorPalette":
        return cls([c for c, _ in PALETTE])

    def find_farthest_color(
        self, region: np.ndarray, max_samples: int = 4096, seed: int = 0
    ) -> Tuple[Tuple[int, int, int], float]:
        """Pick the palette color most visually distant from the pixels of
        `region` (H, W, 3 uint8): maximize the minimum RGB distance to a
        pixel subsample, so the mark stays visible on any background
        (reference som_utils.ColorPalette.find_farthest_color)."""
        px = np.asarray(region, np.float32).reshape(-1, 3)
        if px.shape[0] == 0:
            return self.colors[0], 0.0
        if px.shape[0] > max_samples:
            idx = np.random.RandomState(seed).choice(
                px.shape[0], max_samples, replace=False
            )
            px = px[idx]
        cand = np.asarray(self.colors, np.float32)  # (C, 3)
        d = np.linalg.norm(cand[:, None] - px[None], axis=-1)  # (C, P)
        score = d.min(axis=1)
        best = int(score.argmax())
        return self.colors[best], float(score[best])

    def assign(self, n: int) -> List[Tuple[int, int, int]]:
        return [self.colors[i % len(self.colors)] for i in range(n)]


# --- tiny 5x7 bitmap glyphs for instance-number chips -----------------
_GLYPHS = {
    "0": ("01110", "10001", "10011", "10101", "11001", "10001", "01110"),
    "1": ("00100", "01100", "00100", "00100", "00100", "00100", "01110"),
    "2": ("01110", "10001", "00001", "00110", "01000", "10000", "11111"),
    "3": ("11110", "00001", "00001", "01110", "00001", "00001", "11110"),
    "4": ("00010", "00110", "01010", "10010", "11111", "00010", "00010"),
    "5": ("11111", "10000", "11110", "00001", "00001", "10001", "01110"),
    "6": ("00110", "01000", "10000", "11110", "10001", "10001", "01110"),
    "7": ("11111", "00001", "00010", "00100", "01000", "01000", "01000"),
    "8": ("01110", "10001", "10001", "01110", "10001", "10001", "01110"),
    "9": ("01110", "10001", "10001", "01111", "00001", "00010", "01100"),
}


def _render_text_bitmap(text: str, scale: int) -> np.ndarray:
    """(h, w) bool bitmap of `text` ('0'-'9' glyphs, 1px tracking)."""
    cols = []
    for ch in text:
        g = _GLYPHS.get(ch)
        if g is None:
            continue
        cols.append(np.array([[c == "1" for c in row] for row in g], bool))
        cols.append(np.zeros((7, 1), bool))
    if not cols:
        return np.zeros((7, 1), bool)
    bm = np.concatenate(cols[:-1] if len(cols) > 1 else cols, axis=1)
    return np.kron(bm, np.ones((scale, scale), bool))


def _erode(mask: np.ndarray) -> np.ndarray:
    """4-neighborhood binary erosion via shifts (contour extraction)."""
    m = mask.copy()
    m[1:] &= mask[:-1]
    m[:-1] &= mask[1:]
    m[:, 1:] &= mask[:, :-1]
    m[:, :-1] &= mask[:, 1:]
    return m


def luminance(rgb: Sequence[int]) -> float:
    r, g, b = (float(c) for c in rgb)
    return 0.299 * r + 0.587 * g + 0.114 * b


def draw_mask(
    img: np.ndarray,
    mask: np.ndarray,
    color: Sequence[int],
    alpha: float = 0.35,
    contour: bool = True,
    contour_width: int = 2,
) -> np.ndarray:
    """Alpha-blend `mask` (H, W bool) in `color` onto uint8 `img`, with a
    solid contour so hole boundaries stay visible (reference draw_mask's
    show_holes path draws every polygon boundary)."""
    out = np.asarray(img, np.float32).copy()
    c = np.asarray(color, np.float32)
    m = np.asarray(mask, bool)
    out[m] = (1 - alpha) * out[m] + alpha * c
    if contour:
        edge = m & ~_erode(m)
        for _ in range(contour_width - 1):
            grown = edge.copy()
            grown[1:] |= edge[:-1]
            grown[:-1] |= edge[1:]
            grown[:, 1:] |= edge[:, :-1]
            grown[:, :-1] |= edge[:, 1:]
            edge = grown & (m | edge)
        out[edge] = c
    return np.clip(out, 0, 255).astype(np.uint8)


def draw_box(
    img: np.ndarray,
    box_xyxy: Sequence[float],
    color: Sequence[int],
    width: int = 2,
) -> np.ndarray:
    out = np.asarray(img).copy()
    h, w = out.shape[:2]
    x0, y0, x1, y1 = (int(round(v)) for v in box_xyxy)
    x0, x1 = max(0, min(x0, w - 1)), max(0, min(x1, w - 1))
    y0, y1 = max(0, min(y0, h - 1)), max(0, min(y1, h - 1))
    c = np.asarray(color, np.uint8)
    out[y0 : y0 + width, x0 : x1 + 1] = c
    out[max(y1 - width + 1, 0) : y1 + 1, x0 : x1 + 1] = c
    out[y0 : y1 + 1, x0 : x0 + width] = c
    out[y0 : y1 + 1, max(x1 - width + 1, 0) : x1 + 1] = c
    return out


def draw_number(
    img: np.ndarray,
    number: int,
    xy: Sequence[float],
    color: Sequence[int],
    scale: int = 2,
    pad: int = 2,
) -> np.ndarray:
    """Draw `number` at (x, y) on a filled chip of `color`; glyph is black
    or white, whichever contrasts with the chip (reference draw_text uses
    a matplotlib text with contrast-picked facecolor)."""
    out = np.asarray(img).copy()
    h, w = out.shape[:2]
    bm = _render_text_bitmap(str(number), scale)
    bh, bw = bm.shape
    x = int(round(xy[0]))
    y = int(round(xy[1]))
    x = max(0, min(x, w - bw - 2 * pad))
    y = max(0, min(y, h - bh - 2 * pad))
    chip = np.asarray(color, np.uint8)
    glyph = (
        np.zeros(3, np.uint8) if luminance(color) > 127 else np.full(3, 255, np.uint8)
    )
    out[y : y + bh + 2 * pad, x : x + bw + 2 * pad] = chip
    region = out[y + pad : y + pad + bh, x + pad : x + pad + bw]
    region[bm] = glyph
    return out


def overlay_instances(
    image: np.ndarray,
    masks: Sequence[np.ndarray],
    boxes: Optional[Sequence[Sequence[float]]] = None,
    assigned_colors: Optional[Sequence[Sequence[int]]] = None,
    alpha: float = 0.35,
    label_mode: str = "1",
    number_scale: int = 2,
) -> np.ndarray:
    """SoM render: every instance gets a palette color, a mask overlay,
    its box, and a 1-based number chip at the box corner (reference
    Visualizer.overlay_instances with label_mode='1')."""
    out = np.asarray(image, np.uint8).copy()
    colors = (
        [tuple(int(v) for v in c) for c in assigned_colors]
        if assigned_colors is not None
        else ColorPalette.default().assign(len(masks))
    )
    for i, m in enumerate(masks):
        out = draw_mask(out, m, colors[i], alpha=alpha)
    for i, m in enumerate(masks):
        if boxes is not None and i < len(boxes):
            out = draw_box(out, boxes[i], colors[i])
        if label_mode == "1":
            if boxes is not None and i < len(boxes):
                x0, y0 = boxes[i][0], boxes[i][1]
            else:
                ys, xs = np.nonzero(np.asarray(m, bool))
                x0 = xs.min() if xs.size else 0
                y0 = ys.min() if ys.size else 0
            out = draw_number(out, i + 1, (x0 + 2, y0 + 2), colors[i],
                              scale=number_scale)
    return out
