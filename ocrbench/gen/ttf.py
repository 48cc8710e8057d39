"""A small TrueType reader and rasteriser for the benchmark's pages.

Reads the tables a Latin face needs (head, hhea, hmtx, maxp, cmap format
4, loca, glyf with simple and composite glyphs), flattens each outline's
quadratic curves into line segments and fills it by the nonzero winding
rule on a grid of 4 × 4 samples a pixel, so that a glyph comes out as an
antialiased coverage bitmap. No hinting and no kerning: the benchmark needs
text that looks like print to a text detector, not any one engine's pixels.
Each glyph is rasterised once a run and pasted wherever it is used.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

SUPER = 4  # samples a pixel along each axis
_CURVE_STEPS = 6


class Face:
    """One TrueType face: `glyph(char, px)` → (coverage (h, w) float32 in
    [0, 1], left bearing px, top offset px above the baseline, advance
    px)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.data = f.read()
        n = struct.unpack(">H", self.data[4:6])[0]
        self.tables = {}
        for i in range(n):
            tag, _, off, length = struct.unpack(
                ">4sIII", self.data[12 + 16 * i:28 + 16 * i])
            self.tables[tag.decode("latin-1")] = (off, length)
        head = self._table("head")
        self.units = struct.unpack(">H", head[18:20])[0]
        self.long_loca = struct.unpack(">h", head[50:52])[0] == 1
        hhea = self._table("hhea")
        self.ascent, self.descent = struct.unpack(">hh", hhea[4:8])
        self.n_hmetrics = struct.unpack(">H", hhea[34:36])[0]
        self.n_glyphs = struct.unpack(">H", self._table("maxp")[4:6])[0]
        self._cmap = self._read_cmap()
        self._cache: Dict[Tuple[str, float], tuple] = {}

    def _table(self, tag: str) -> bytes:
        off, length = self.tables[tag]
        return self.data[off:off + length]

    def _read_cmap(self) -> Dict[int, int]:
        cmap = self._table("cmap")
        n = struct.unpack(">H", cmap[2:4])[0]
        for i in range(n):
            pid, eid, off = struct.unpack(">HHI", cmap[4 + 8 * i:12 + 8 * i])
            if (pid, eid) in ((3, 1), (0, 3)) and \
                    struct.unpack(">H", cmap[off:off + 2])[0] == 4:
                return self._cmap4(cmap[off:])
        raise ValueError("no format 4 Unicode cmap")

    @staticmethod
    def _cmap4(t: bytes) -> Dict[int, int]:
        segx2 = struct.unpack(">H", t[6:8])[0]
        seg = segx2 // 2
        ends = struct.unpack(f">{seg}H", t[14:14 + segx2])
        base = 16 + segx2
        starts = struct.unpack(f">{seg}H", t[base:base + segx2])
        deltas = struct.unpack(f">{seg}h", t[base + segx2:base + 2 * segx2])
        ro_at = base + 2 * segx2
        offs = struct.unpack(f">{seg}H", t[ro_at:ro_at + segx2])
        out = {}
        for i in range(seg):
            for c in range(starts[i], min(ends[i], 0x2FFF) + 1):
                if offs[i] == 0:
                    g = (c + deltas[i]) & 0xFFFF
                else:
                    at = ro_at + 2 * i + offs[i] + 2 * (c - starts[i])
                    g = struct.unpack(">H", t[at:at + 2])[0]
                    if g:
                        g = (g + deltas[i]) & 0xFFFF
                if g:
                    out[c] = g
        return out

    def _advance(self, gid: int) -> int:
        hmtx = self._table("hmtx")
        i = min(gid, self.n_hmetrics - 1)
        return struct.unpack(">H", hmtx[4 * i:4 * i + 2])[0]

    def _glyph_bytes(self, gid: int) -> bytes:
        loca = self._table("loca")
        if self.long_loca:
            a, b = struct.unpack(">II", loca[4 * gid:4 * gid + 8])
        else:
            a, b = (2 * x for x in struct.unpack(">HH", loca[2 * gid:
                                                              2 * gid + 4]))
        return self._table("glyf")[a:b]

    def contours(self, gid: int) -> List[List[Tuple[float, float, bool]]]:
        """The glyph's contours in font units: lists of (x, y, on_curve)."""
        g = self._glyph_bytes(gid)
        if not g:
            return []
        n = struct.unpack(">h", g[:2])[0]
        if n < 0:
            return self._composite(g)
        ends = struct.unpack(f">{n}H", g[10:10 + 2 * n])
        at = 10 + 2 * n
        at += 2 + struct.unpack(">H", g[at:at + 2])[0]
        n_pts = ends[-1] + 1 if n else 0
        flags = []
        while len(flags) < n_pts:
            f = g[at]
            at += 1
            flags.append(f)
            if f & 8:
                flags.extend([f] * g[at])
                at += 1
        coords = []
        for short, same in ((2, 16), (4, 32)):
            v, vals = 0, []
            for f in flags:
                if f & short:
                    d = g[at]
                    at += 1
                    v += d if f & same else -d
                elif not f & same:
                    v += struct.unpack(">h", g[at:at + 2])[0]
                    at += 2
                vals.append(v)
            coords.append(vals)
        pts = [(x, y, bool(f & 1)) for x, y, f in zip(*coords, flags)]
        out, start = [], 0
        for e in ends:
            out.append(pts[start:e + 1])
            start = e + 1
        return out

    def _composite(self, g: bytes):
        out, at = [], 10
        while True:
            flags, gid = struct.unpack(">HH", g[at:at + 4])
            at += 4
            if flags & 1:
                dx, dy = struct.unpack(">hh", g[at:at + 4])
                at += 4
            else:
                dx, dy = struct.unpack(">bb", g[at:at + 2])
                at += 2
            a, b, c, d = 1.0, 0.0, 0.0, 1.0
            if flags & 8:
                a = d = struct.unpack(">h", g[at:at + 2])[0] / 16384.0
                at += 2
            elif flags & 0x40:
                a, d = (v / 16384.0 for v in struct.unpack(">hh",
                                                           g[at:at + 4]))
                at += 4
            elif flags & 0x80:
                a, b, c, d = (v / 16384.0 for v in struct.unpack(
                    ">hhhh", g[at:at + 8]))
                at += 8
            if not flags & 2:
                dx = dy = 0  # point matching: not used by Latin faces
            for cont in self.contours(gid):
                out.append([(a * x + c * y + dx, b * x + d * y + dy, on)
                            for x, y, on in cont])
            if not flags & 0x20:
                return out

    def glyph(self, char: str, px: float):
        key = (char, px)
        if key not in self._cache:
            self._cache[key] = self._render(char, px)
        return self._cache[key]

    def _render(self, char: str, px: float):
        gid = self._cmap.get(ord(char), 0)
        scale = px / self.units
        adv = self._advance(gid) * scale
        segs = []
        for cont in self.contours(gid):
            pts = _flatten(cont)
            if len(pts) >= 2:
                p = np.asarray(pts, np.float64) * scale
                segs.append(np.concatenate([p, np.roll(p, -1, 0)], 1))
        if not segs:
            return np.zeros((0, 0), np.float32), 0, 0, adv
        e = np.concatenate(segs)  # (n, 4): x0 y0 x1 y1, y up
        x0 = int(np.floor(min(e[:, 0].min(), e[:, 2].min())))
        x1 = int(np.ceil(max(e[:, 0].max(), e[:, 2].max())))
        y0 = int(np.floor(min(e[:, 1].min(), e[:, 3].min())))
        y1 = int(np.ceil(max(e[:, 1].max(), e[:, 3].max())))
        w, h = x1 - x0, y1 - y0
        # sample grid: rows from the top (y1) down, SUPER a pixel
        ex0 = (e[:, 0] - x0) * SUPER
        ex1 = (e[:, 2] - x0) * SUPER
        ey0 = (y1 - e[:, 1]) * SUPER
        ey1 = (y1 - e[:, 3]) * SUPER
        cov = _fill(ex0, ey0, ex1, ey1, h * SUPER, w * SUPER)
        bitmap = cov.reshape(h, SUPER, w, SUPER).mean((1, 3)).astype(
            np.float32)
        return bitmap, x0, y1, adv


def _flatten(cont):
    """A TrueType contour (quadratic B-spline with implied on-curve
    midpoints) → a closed polyline."""
    n = len(cont)
    if n == 0:
        return []
    pts = []
    # start at an on-curve point, or the midpoint of the first two
    start = next((i for i, p in enumerate(cont) if p[2]), None)
    if start is None:
        a, b = cont[0], cont[1]
        cont = [((a[0] + b[0]) / 2, (a[1] + b[1]) / 2, True)] + list(cont)
        start = 0
        n = len(cont)
    seq = [cont[(start + i) % n] for i in range(n)] + [cont[start]]
    cur = seq[0][:2]
    pts.append(cur)
    ctrl = None
    for x, y, on in seq[1:]:
        if on:
            if ctrl is None:
                pts.append((x, y))
            else:
                pts.extend(_quad(cur, ctrl, (x, y)))
                ctrl = None
            cur = (x, y)
        else:
            if ctrl is not None:
                mid = ((ctrl[0] + x) / 2, (ctrl[1] + y) / 2)
                pts.extend(_quad(cur, ctrl, mid))
                cur = mid
            ctrl = (x, y)
    return pts[:-1]


def _quad(p0, p1, p2):
    t = np.arange(1, _CURVE_STEPS + 1) / _CURVE_STEPS
    x = (1 - t) ** 2 * p0[0] + 2 * (1 - t) * t * p1[0] + t ** 2 * p2[0]
    y = (1 - t) ** 2 * p0[1] + 2 * (1 - t) * t * p1[1] + t ** 2 * p2[1]
    return list(zip(x, y))


def _fill(x0, y0, x1, y1, rows: int, cols: int) -> np.ndarray:
    """Nonzero-winding fill of the segments on a rows × cols sample grid
    (sample centres at +0.5) → bool (rows, cols)."""
    up = y1 < y0
    ya, yb = np.where(up, y1, y0), np.where(up, y0, y1)
    xa, xb = np.where(up, x1, x0), np.where(up, x0, x1)
    r0 = np.ceil(ya - 0.5).astype(np.int64)
    r1 = np.ceil(yb - 0.5).astype(np.int64)  # rows r0 .. r1 - 1
    counts = np.maximum(r1 - r0, 0)
    seg = np.repeat(np.arange(len(x0)), counts)
    if len(seg) == 0:
        return np.zeros((rows, cols), bool)
    row = r0[seg] + (np.arange(len(seg)) - np.repeat(
        np.cumsum(counts) - counts, counts))
    yc = row + 0.5
    t = (yc - ya[seg]) / (yb[seg] - ya[seg])
    xc = xa[seg] + t * (xb[seg] - xa[seg])
    col = np.clip(np.ceil(xc - 0.5).astype(np.int64), 0, cols)
    delta = np.where(up[seg], 1, -1)
    ok = (row >= 0) & (row < rows)
    acc = np.zeros((rows, cols + 1), np.int32)
    np.add.at(acc, (row[ok], col[ok]), delta[ok])
    return np.cumsum(acc, axis=1)[:, :cols] != 0
