"""Host rasteriser of the overlay's draw commands (render/overlay.py) into
a uint8 frame: lines, ellipse outlines and text, all commands of a frame at
once in numpy, painted in command order (where two commands cover a pixel,
the later one's colour stays). It stands where the JAX package draws with
PIL's ImageDraw, and puts each primitive within a pixel of where ImageDraw
puts it (tests/test_torch_render.py):

- coordinates are truncated toward zero, as ImageDraw's C core casts them;
- a line visits one pixel per step along its major axis; a wider line adds
  the two copies shifted to the edges of ImageDraw's wide-line polygon;
- an ellipse outline is the ring of pixels of its integer bounding box,
  `width` pixels thick;
- text uses a bitmap of the characters the labels need ('PP.UU.C' ids:
  digits, '.', '-', 'A', 'B'), each glyph Pillow's default font (Aileron
  Regular, 10 px) rendered at a whole-pixel origin and thresholded at
  32/255, at the pixel FreeType rounds the origin to. A character outside
  the table advances by 6 pixels and draws nothing. Text that crosses the
  frame's top edge can differ from ImageDraw's by a row, which ImageDraw
  clips there.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

LINE, ELLIPSE, TEXT = 0, 1, 2

# char: (advance, top row below the text origin, row bitmasks top to bottom;
# bit i of a row is column i).
GLYPHS = {
    "0": (6, 2, (0xe, 0x1b, 0x11, 0x11, 0x11, 0x11, 0x1b, 0xe)),
    "1": (6, 2, (0xc, 0xe, 0x8, 0x8, 0x8, 0x8, 0x8, 0x8)),
    "2": (6, 2, (0x1e, 0x1a, 0x13, 0x18, 0xc, 0xc, 0x6, 0x1f)),
    "3": (6, 2, (0x1e, 0x13, 0x18, 0x1c, 0x18, 0x11, 0x1b, 0x1e)),
    "4": (6, 2, (0x18, 0x18, 0x1c, 0x16, 0x12, 0x3f, 0x10, 0x10)),
    "5": (6, 2, (0x1f, 0x3, 0x3, 0x1f, 0x1b, 0x11, 0x1b, 0x1f)),
    "6": (6, 2, (0x1e, 0x1b, 0x13, 0x1f, 0x1b, 0x11, 0x1b, 0x1e)),
    "7": (6, 2, (0x1f, 0x18, 0x8, 0xc, 0xc, 0x6, 0x6, 0x3)),
    "8": (6, 2, (0x1f, 0x1b, 0x1b, 0x1f, 0x1b, 0x11, 0x1b, 0x1f)),
    "9": (6, 2, (0xf, 0x1b, 0x11, 0x1b, 0x1f, 0x19, 0x1b, 0xf)),
    ".": (2, 9, (0x1,)),
    "-": (3, 6, (0x7,)),
    "A": (6, 2, (0xc, 0x1c, 0x1c, 0x16, 0x3e, 0x32, 0x23, 0x63)),
    "B": (6, 2, (0x3e, 0x32, 0x22, 0x32, 0x3e, 0x32, 0x22, 0x3e)),
}
_MISSING_ADVANCE = 6


def _font_tables():
    """(advance[256], pixel start[257], pixel dx, pixel dy) over byte
    codes: glyph c's pixels are dx/dy[start[c]:start[c + 1]]."""
    adv = np.full(256, _MISSING_ADVANCE, np.int64)
    counts = np.zeros(256, np.int64)
    dxs, dys = [[] for _ in range(256)], [[] for _ in range(256)]
    for ch, (a, top, rows) in GLYPHS.items():
        c = ord(ch)
        adv[c] = a
        for r, bits in enumerate(rows):
            for col in range(8):
                if bits >> col & 1:
                    dxs[c].append(col)
                    dys[c].append(top + r)
        counts[c] = len(dxs[c])
    start = np.concatenate([[0], np.cumsum(counts)])
    return (adv, start, np.array(sum(dxs, []), np.int64),
            np.array(sum(dys, []), np.int64))


_ADV, _START, _DX, _DY = _font_tables()


@dataclass
class DrawList:
    """Draw commands in paint order. xy: a line's (x0, y0, x1, y1), an
    ellipse's bounding box (x0, y0, x1, y1), a text's origin (x, y, 0, 0);
    fill: the RGB colour (an ellipse's outline); width: line or outline
    width (0 for text); text: the string of each command ('' unless
    text)."""

    kind: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    xy: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 4), np.float32))
    fill: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), np.uint8))
    width: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    text: list = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.kind)

    @staticmethod
    def of(kind: int, xy, fill, width, text=None) -> "DrawList":
        """Commands of one kind: xy [M, 4], fill [M, 3] (or one colour),
        width an int or [M]."""
        xy = np.asarray(xy, np.float32).reshape(-1, 4)
        m = len(xy)
        return DrawList(
            kind=np.full(m, kind, np.int8), xy=xy,
            fill=np.broadcast_to(np.asarray(fill, np.uint8), (m, 3)).copy(),
            width=np.broadcast_to(np.asarray(width, np.int32), (m,)).copy(),
            text=list(text) if text is not None else [""] * m)

    def __add__(self, other: "DrawList") -> "DrawList":
        return DrawList(
            kind=np.concatenate([self.kind, other.kind]),
            xy=np.concatenate([self.xy, other.xy]),
            fill=np.concatenate([self.fill, other.fill]),
            width=np.concatenate([self.width, other.width]),
            text=self.text + other.text)

    def calls(self) -> list[tuple]:
        """The commands as ImageDraw calls: ("line", ((x0, y0), (x1, y1)),
        fill, width), ("ellipse", (x0, y0, x1, y1), outline, width),
        ("text", (x, y), text, fill)."""
        out = []
        for k, xy, f, w, t in zip(self.kind, self.xy.tolist(),
                                  map(tuple, self.fill.tolist()),
                                  self.width.tolist(), self.text):
            if k == LINE:
                out.append(("line", (tuple(xy[:2]), tuple(xy[2:])), f, w))
            elif k == ELLIPSE:
                out.append(("ellipse", tuple(xy), f, w))
            else:
                out.append(("text", tuple(xy[:2]), t, f))
        return out


def _expand(counts: np.ndarray):
    """(owner, local index) of sum(counts) items, item i of owner j for
    i < counts[j]."""
    owner = np.repeat(np.arange(len(counts)), counts)
    first = np.cumsum(counts) - counts
    return owner, np.arange(int(counts.sum())) - first[owner]


def _line_pixels(x0, y0, x1, y1):
    """(owner, x, y) of integer segments, one pixel per step along each
    segment's major axis."""
    dx, dy = x1 - x0, y1 - y0
    n = np.maximum(np.abs(dx), np.abs(dy))
    owner, t = _expand(n + 1)
    span = np.maximum(n, 1)[owner]
    x = x0[owner] + np.floor(t * dx[owner] / span + 0.5).astype(np.int64)
    y = y0[owner] + np.floor(t * dy[owner] / span + 0.5).astype(np.int64)
    return owner, x, y


def _round_up(f):
    return np.where(f >= 0, np.floor(f + 0.5), -np.floor(np.abs(f) + 0.5))


def _round_down(f):
    return np.where(f >= 0, np.ceil(f - 0.5), -np.ceil(np.abs(f) - 0.5))


def _lines(xy, width):
    """(owner, x, y) of line commands. A line wider than one pixel also
    draws its copies shifted to the two long edges of ImageDraw's
    wide-line polygon."""
    p = np.trunc(xy).astype(np.int64)
    x0, y0, x1, y1 = p.T
    owners, xs, ys = [], [], []
    shifts = [(np.zeros_like(x0), np.zeros_like(x0))]
    wide = width > 1
    if wide.any():
        dx, dy = (x1 - x0).astype(np.float64), (y1 - y0).astype(np.float64)
        length = np.maximum(np.hypot(dx, dy), 1e-12)
        half = (width - 1) / 2.0
        r_max = _round_up(half) / length
        r_min = _round_down(half) / length
        dxmin = _round_down(r_min * dy).astype(np.int64)
        dxmax = _round_down(r_max * dy).astype(np.int64)
        dymin = _round_down(r_min * dx).astype(np.int64)
        dymax = _round_down(r_max * dx).astype(np.int64)
        shifts += [(np.where(wide, -dxmin, 0), np.where(wide, dymax, 0)),
                   (np.where(wide, dxmax, 0), np.where(wide, -dymin, 0))]
    for sx, sy in shifts:
        o, x, y = _line_pixels(x0 + sx, y0 + sy, x1 + sx, y1 + sy)
        owners.append(o)
        xs.append(x)
        ys.append(y)
    return np.concatenate(owners), np.concatenate(xs), np.concatenate(ys)


@functools.lru_cache(maxsize=64)
def _ring(a: int, b: int, width: int):
    """(dx, dy) of the outline of the ellipse in an integer box of a × b
    (a + 1 by b + 1 pixels): the pixels inside the ellipse inscribed in
    the box (pixel centres, the box's edge pixels counted in) and outside
    the one `width` pixels smaller."""
    y, x = np.mgrid[0:b + 1, 0:a + 1]
    ra, rb = a / 2.0 + 0.5, b / 2.0 + 0.5
    ux, uy = x - a / 2.0, y - b / 2.0
    outer = (ux / ra) ** 2 + (uy / rb) ** 2 <= 1.0
    ia, ib = ra - width, rb - width
    inner = ((ia > 0) and (ib > 0)) and (
        (ux / max(ia, 1e-12)) ** 2 + (uy / max(ib, 1e-12)) ** 2 < 1.0)
    keep = outer & ~inner
    return x[keep], y[keep]


def _ellipses(xy, width):
    """(owner, x, y) of ellipse outlines: each box's ring (_ring), shared
    by every ellipse of the same integer size and width."""
    p = np.trunc(xy).astype(np.int64)
    x0, y0, x1, y1 = p.T
    a, b = np.maximum(x1 - x0, 0), np.maximum(y1 - y0, 0)
    w = width.astype(np.int64)
    span = max(int(b.max()), int(w.max())) + 1
    kinds, which = np.unique((a * span + b) * span + w, return_inverse=True)
    owners, xs, ys = [], [], []
    for k, key in enumerate(kinds.tolist()):
        dx, dy = _ring(key // span // span, key // span % span, key % span)
        members = np.nonzero(which == k)[0]
        owner = np.repeat(members, len(dx))
        owners.append(owner)
        xs.append(x0[owner] + np.tile(dx, len(members)))
        ys.append(y0[owner] + np.tile(dy, len(members)))
    return np.concatenate(owners), np.concatenate(xs), np.concatenate(ys)


def _texts(xy, texts):
    """(owner, x, y) of text commands from the glyph bitmaps."""
    if not texts:
        return (np.zeros(0, np.int64),) * 3
    raw = "".join(texts).encode("latin-1", errors="replace")
    codes = np.frombuffer(raw, np.uint8).astype(np.int64)
    lens = np.array([len(t) for t in texts], np.int64)
    owner, _ = _expand(lens)
    adv = _ADV[codes]
    cum = np.cumsum(adv) - adv            # pen position from the first text
    first = np.cumsum(lens) - lens        # each text's first character
    pen = cum - np.append(cum, 0)[first][owner]
    # ImageDraw splits the origin into whole pixels and a rest, which
    # FreeType takes in 1/64 pixel and rounds: x moves on from 32/64, y
    # from 33/64.
    lo = np.floor(xy[:, :2])
    rest = np.rint((xy[:, :2] - lo) * 64)
    origin = (lo + (rest >= np.array([32, 33]))).astype(np.int64)
    n = _START[codes + 1] - _START[codes]
    char, k = _expand(n)
    src = _START[codes][char] + k
    o = owner[char]
    return (o, origin[o, 0] + pen[char] + _DX[src],
            origin[o, 1] + _DY[src])


def rasterize(arr: np.ndarray, cmds: DrawList) -> np.ndarray:
    """Paint `cmds` into the [H, W, 3] uint8 array `arr` (in place, and
    returned)."""
    if not len(cmds):
        return arr
    h, w = arr.shape[:2]
    parts = []
    for kind, fn in ((LINE, lambda i: _lines(cmds.xy[i], cmds.width[i])),
                     (ELLIPSE, lambda i: _ellipses(cmds.xy[i],
                                                   cmds.width[i])),
                     (TEXT, lambda i: _texts(cmds.xy[i],
                                             [cmds.text[j] for j in i]))):
        idx = np.nonzero(cmds.kind == kind)[0]
        if len(idx):
            o, x, y = fn(idx)
            parts.append((idx[o], x, y))
    cmd = np.concatenate([p[0] for p in parts])
    x = np.concatenate([p[1] for p in parts])
    y = np.concatenate([p[2] for p in parts])
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    pix = y[inside] * w + x[inside]
    last = np.full(h * w, -1, np.int64)
    np.maximum.at(last, pix, cmd[inside])
    hit = np.nonzero(last >= 0)[0]
    arr.reshape(-1, 3)[hit] = cmds.fill[last[hit]]
    return arr
