"""Minimal pure-Python rasterizer for digitally-born (vector) PDFs:
counterpart of onnxocr_tpu/batch/pdf_raster.py.

The reference rasterizes every PDF page via pymupdf
(onnxocr/ocr_images_pdfs.py:22-35); that C library is absent here, so this
module renders the *text + filled-rectangle subset* of PDF content streams
— enough to OCR typical text-first documents (invoices, reports, generated
letters). The JAX package draws with PIL; this one with PIL's twins:
utils/pil_ops.py (canvas, rectangles, resize, affine transform, masked
paste: value-equal to PIL) and utils/font.py (TrueType text: PIL's layout,
unhinted glyph coverage). Supported:

  * page tree traversal (/Root → /Pages → /Kids), MediaBox inheritance
  * FlateDecode content streams, multiple /Contents parts
  * graphics state: q/Q, cm (full 2D affine CTM), rg/g fill color
  * text state: BT/ET, Tf, Td, TD, TL, Tm, T*, Tj, ', TJ (with kerning)
  * paths: re + f/f*/b/B filled rectangles (axis-aligned after CTM)
  * WinAnsi/Latin-1 byte strings; fonts approximated by DejaVu variants
    picked from /BaseFont (bold/serif/mono heuristics)
  * image XObjects via Do — the scanned-PDF case (reference renders these
    through pymupdf, onnxocr/ocr_images_pdfs.py:22-35): DCTDecode (JPEG as
    PIL reads it, utils/imcodec.jpeg_pil_rgb: gray/RGB/CMYK), FlateDecode bitmaps (1/8-bit gray, RGB, CMYK,
    Indexed palettes, PNG predictors 10-15), placed by the full affine CTM
    (axis-aligned fast path; inverse-affine transform otherwise)

Unsupported content (curves, shadings, CID fonts, Form XObjects, SMask
transparency) is skipped silently — the goal is OCR-able pixels, not
print fidelity.
"""
from __future__ import annotations

import re
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import font as font_mod
from ..utils import imcodec, pil_ops

# the JAX package's system DejaVu paths, else the package's copies
_FONT_FILES = {
    ("serif", False): font_mod.dejavu_path("DejaVuSerif.ttf"),
    ("serif", True): font_mod.dejavu_path("DejaVuSerif-Bold.ttf"),
    ("sans", False): font_mod.dejavu_path("DejaVuSans.ttf"),
    ("sans", True): font_mod.dejavu_path("DejaVuSans-Bold.ttf"),
    ("mono", False): font_mod.dejavu_path("DejaVuSansMono.ttf"),
    ("mono", True): font_mod.dejavu_path("DejaVuSansMono-Bold.ttf"),
}


# --------------------------------------------------------------- object model
class _Objects:
    """Indirect-object index: number → (dict_head bytes, stream or None)."""

    def __init__(self, data: bytes):
        self.data = data
        self.by_num: Dict[int, Tuple[bytes, Optional[bytes]]] = {}
        for m in re.finditer(rb"(\d+)\s+\d+\s+obj\b", data):
            num = int(m.group(1))
            start = m.end()
            end = data.find(b"endobj", start)
            if end < 0:
                continue
            body = data[start:end]
            sm = re.search(rb"stream\r?\n", body)
            if sm:
                head, stream = body[:sm.start()], body[sm.end():]
                es = stream.rfind(b"endstream")
                if es >= 0:
                    stream = stream[:es]
                    if stream.endswith(b"\n"):
                        stream = stream[:-1]
                    if stream.endswith(b"\r"):
                        stream = stream[:-1]
            else:
                head, stream = body, None
            self.by_num[num] = (head, stream)

    def resolve(self, head: bytes, key: bytes):
        """Value of /key in a dict: returns (literal bytes) with refs
        followed one level."""
        m = re.search(re.escape(key) + rb"\s*(\d+)\s+\d+\s+R", head)
        if m:
            return self.by_num.get(int(m.group(1)))
        return None

    def stream_of(self, num: int) -> Optional[bytes]:
        head, stream = self.by_num.get(num, (b"", None))
        if stream is None:
            return None
        if b"/FlateDecode" in head:
            try:
                return zlib.decompress(stream)
            except zlib.error:
                return None
        return stream


def _find_pages(objs: _Objects) -> List[int]:
    """Page object numbers in tree order (falls back to file order)."""
    pages = []

    def walk(num, seen):
        if num in seen:
            return
        seen.add(num)
        head, _ = objs.by_num.get(num, (b"", None))
        if re.search(rb"/Type\s*/Page\b(?!s)", head):
            pages.append(num)
            return
        kids = re.search(rb"/Kids\s*\[(.*?)\]", head, re.S)
        if kids:
            for km in re.finditer(rb"(\d+)\s+\d+\s+R", kids.group(1)):
                walk(int(km.group(1)), seen)

    roots = [num for num, (head, _) in objs.by_num.items()
             if re.search(rb"/Type\s*/Pages\b", head)]
    seen: set = set()
    for r in roots:
        walk(r, seen)
    if not pages:
        pages = [num for num, (head, _) in sorted(objs.by_num.items())
                 if re.search(rb"/Type\s*/Page\b(?!s)", head)]
    return pages


def _media_box(objs: _Objects, num: int) -> Tuple[float, float]:
    seen = set()
    while num and num not in seen:
        seen.add(num)
        head, _ = objs.by_num.get(num, (b"", None))
        m = re.search(rb"/MediaBox\s*\[\s*([\d.+-]+)\s+([\d.+-]+)\s+"
                      rb"([\d.+-]+)\s+([\d.+-]+)", head)
        if m:
            x0, y0, x1, y1 = (float(m.group(i)) for i in range(1, 5))
            return abs(x1 - x0), abs(y1 - y0)
        parent = re.search(rb"/Parent\s+(\d+)\s+\d+\s+R", head)
        num = int(parent.group(1)) if parent else 0
    return 612.0, 792.0


def _page_fonts(objs: _Objects, num: int) -> Dict[bytes, Tuple[str, bool]]:
    """Font resource name → (family, bold) picked from /BaseFont."""
    head, _ = objs.by_num.get(num, (b"", None))
    font_dict = head
    res = objs.resolve(head, b"/Resources")
    if res:
        font_dict = res[0]
    fonts: Dict[bytes, Tuple[str, bool]] = {}
    region = font_dict
    fm = re.search(rb"/Font\s*<<(.*?)>>", region, re.S)
    if fm:
        region = fm.group(1)
    for m in re.finditer(rb"/(\w+)\s+(\d+)\s+\d+\s+R", region):
        fhead, _ = objs.by_num.get(int(m.group(2)), (b"", None))
        base = re.search(rb"/BaseFont\s*/([#\w+-]+)", fhead)
        name = (base.group(1).lower() if base else b"")
        family = "sans"
        if b"times" in name or b"serif" in name or b"roman" in name or \
                b"georgia" in name or b"garamond" in name:
            family = "serif"
        elif b"courier" in name or b"mono" in name or b"consol" in name:
            family = "mono"
        bold = b"bold" in name or b"black" in name or b"heavy" in name
        fonts[m.group(1)] = (family, bold)
    return fonts


def _resources_head(objs: _Objects, num: int) -> bytes:
    """The page's /Resources dict head, following one ref level and the
    /Parent chain (resources inherit from the Pages node)."""
    seen = set()
    while num and num not in seen:
        seen.add(num)
        head, _ = objs.by_num.get(num, (b"", None))
        if b"/Resources" in head:
            res = objs.resolve(head, b"/Resources")
            return res[0] if res else head
        parent = re.search(rb"/Parent\s+(\d+)\s+\d+\s+R", head)
        num = int(parent.group(1)) if parent else 0
    return b""


def _page_xobjects(objs: _Objects, num: int) -> Dict[bytes, int]:
    """XObject resource name → object number."""
    region = _resources_head(objs, num)
    xm = re.search(rb"/XObject\s*(\d+)\s+\d+\s+R", region)
    if xm:
        entry = objs.by_num.get(int(xm.group(1)))
        region = entry[0] if entry else b""
    else:
        xm = re.search(rb"/XObject\s*<<(.*?)>>", region, re.S)
        region = xm.group(1) if xm else b""
    return {m.group(1): int(m.group(2))
            for m in re.finditer(rb"/([^\s/<>\[\]()]+)\s+(\d+)\s+\d+\s+R",
                                 region)}


def _colorspace_ncomp(objs: _Objects, head: bytes):
    """(n_components, palette or None) for an image's /ColorSpace."""
    m = re.search(rb"/ColorSpace\s*(\d+)\s+\d+\s+R", head)
    if m:
        entry = objs.by_num.get(int(m.group(1)), (b"", None))
        head = b"/ColorSpace " + entry[0]
    m = re.search(rb"/ColorSpace\s*(/\w+|\[.*?\])", head, re.S)
    if not m:
        return 3, None
    cs = m.group(1)
    if cs.startswith(b"/"):
        return {b"/DeviceGray": 1, b"/CalGray": 1, b"/DeviceCMYK": 4,
                }.get(cs, 3), None
    if b"/Indexed" in cs:
        # [/Indexed base hival lookup] — lookup is a string or stream ref
        base_n = 3
        if b"Gray" in cs:
            base_n = 1
        elif b"CMYK" in cs:
            base_n = 4
        pal = None
        sm = re.search(rb"\(((?:\\.|[^\\()])*)\)\s*\]", cs, re.S)
        if sm:
            pal = _decode_string(b"(" + sm.group(1) + b")").encode("latin-1")
        else:
            rm = re.search(rb"(\d+)\s+\d+\s+R\s*\]", cs)
            if rm:
                pal = objs.stream_of(int(rm.group(1)))
        if pal is not None:
            p = np.frombuffer(pal, np.uint8)
            if base_n == 1:
                p = np.repeat(p[:, None], 3, axis=1)
            else:
                p = p[:len(p) - len(p) % base_n].reshape(-1, base_n)
                if base_n == 4:
                    c = p.astype(np.float32) / 255.0
                    p = ((1 - c[:, :3]) * (1 - c[:, 3:4]) * 255).astype(
                        np.uint8)
            return 1, p[:, :3]
        return 1, None
    if b"/ICCBased" in cs:
        rm = re.search(rb"/ICCBased\s+(\d+)\s+\d+\s+R", cs)
        if rm:
            ihead, _ = objs.by_num.get(int(rm.group(1)), (b"", None))
            nm = re.search(rb"/N\s+(\d+)", ihead)
            if nm:
                return int(nm.group(1)), None
    return 3, None


def _png_unpredict(data: bytes, rowlen: int) -> bytes:
    """Undo PNG row predictors (DecodeParms /Predictor >= 10, 8-bit,
    bpp = colors assumed from /Colors; rowlen excludes the filter byte)."""
    nrows = len(data) // (rowlen + 1)
    raw = np.frombuffer(data[:nrows * (rowlen + 1)],
                        np.uint8).reshape(nrows, rowlen + 1)
    ftypes = raw[:, 0]
    rows = raw[:, 1:].astype(np.int32)
    out = np.zeros_like(rows)
    prev = np.zeros((rowlen,), np.int32)
    bpp = 1  # per-byte predictors; /Colors shifts only Sub/Paeth left refs
    for r in range(nrows):
        f = int(ftypes[r])
        cur = rows[r]
        if f == 0:
            line = cur
        elif f == 2:  # Up
            line = (cur + prev) & 0xFF
        else:  # Sub/Average/Paeth need the sequential left neighbor
            line = np.zeros_like(cur)
            left = np.zeros((bpp,), np.int32)
            for i in range(rowlen):
                a = int(line[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                if f == 1:
                    v = cur[i] + a
                elif f == 3:
                    v = cur[i] + (a + b) // 2
                else:  # Paeth
                    c = int(out[r - 1, i - bpp]) if (r > 0 and i >= bpp) \
                        else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else \
                        (b if pb <= pc else c)
                    v = cur[i] + pred
                line[i] = v & 0xFF
            del left
        out[r] = line
        prev = line
    return out.astype(np.uint8).tobytes()


def _decode_image_xobject(objs: _Objects, num: int) -> Optional[np.ndarray]:
    """Image XObject → (h, w, 3) uint8 RGB, or None when unsupported."""
    head, raw = objs.by_num.get(num, (b"", None))
    if raw is None or not re.search(rb"/Subtype\s*/Image\b", head):
        return None
    if re.search(rb"/ImageMask\s+true", head):
        return None  # stencil masks carry no OCR pixels of their own
    wm = re.search(rb"/Width\s+(\d+)", head)
    hm = re.search(rb"/Height\s+(\d+)", head)
    if not wm or not hm:
        return None
    w, h = int(wm.group(1)), int(hm.group(1))
    bm = re.search(rb"/BitsPerComponent\s+(\d+)", head)
    bpc = int(bm.group(1)) if bm else 8
    # Filters we cannot decode (reference gets them free via pymupdf,
    # onnxocr/ocr_images_pdfs.py:22-35) degrade per-image with a warning —
    # the page still renders its text/other images, the batch never dies.
    unsupported = re.findall(
        rb"/(CCITTFaxDecode|JBIG2Decode|JPXDecode|LZWDecode|"
        rb"RunLengthDecode|CCF|LZW|RL)\b", head.split(b"stream")[0])
    if unsupported:
        import logging
        logging.getLogger(__name__).warning(
            "pdf_raster: unsupported image filter %s — skipping image "
            "XObject (obj %d)",
            b",".join(sorted(set(unsupported))).decode("ascii",
                                                       "replace"), num)
        return None
    filters = re.findall(
        rb"/(DCTDecode|FlateDecode|ASCIIHexDecode|ASCII85Decode|DCT|Fl)\b",
        head.split(b"stream")[0])

    data = raw
    try:
        for f in filters:
            if f == b"ASCIIHexDecode":
                hexs = re.sub(rb"[^0-9A-Fa-f]", b"", data.split(b">")[0])
                if len(hexs) % 2:
                    hexs += b"0"
                data = bytes.fromhex(hexs.decode("ascii"))
            elif f == b"ASCII85Decode":
                import base64
                body = data.split(b"~>")[0]
                data = base64.a85decode(re.sub(rb"\s", b"", body))
            elif f in (b"FlateDecode", b"Fl"):
                data = zlib.decompress(data)
            elif f in (b"DCTDecode", b"DCT"):
                # PIL's Image.open(...).convert("RGB"); unreadable → None
                return imcodec.jpeg_pil_rgb(data)
    except Exception:
        return None

    # raw bitmap path (after Flate/ASCII decode)
    ncomp, palette = _colorspace_ncomp(objs, head)
    pm = re.search(rb"/Predictor\s+(\d+)", head)
    if pm and int(pm.group(1)) >= 10 and bpc == 8:
        try:
            data = _png_unpredict(data, w * ncomp)
        except Exception:
            return None
    try:
        if bpc == 1:
            bits = np.unpackbits(
                np.frombuffer(data, np.uint8)[:h * ((w + 7) // 8)]
                .reshape(h, (w + 7) // 8), axis=1)[:, :w]
            gray = (bits * 255).astype(np.uint8)
            return np.repeat(gray[:, :, None], 3, axis=2)
        if bpc != 8:
            return None
        px = np.frombuffer(data, np.uint8)
        if len(px) < h * w * ncomp:
            return None
        px = px[:h * w * ncomp].reshape(h, w, ncomp)
        if palette is not None:
            idx = np.clip(px[:, :, 0], 0, len(palette) - 1)
            return palette[idx]
        if ncomp == 1:
            return np.repeat(px, 3, axis=2)
        if ncomp == 4:  # CMYK
            c = px.astype(np.float32) / 255.0
            rgb = (1 - c[:, :, :3]) * (1 - c[:, :, 3:4])
            return (rgb * 255).astype(np.uint8)
        return px[:, :, :3]
    except Exception:
        return None


# ------------------------------------------------------------ content tokens
_TOKEN_RE = re.compile(
    rb"\((?:\\.|[^\\()])*\)"      # literal string
    rb"|<[0-9A-Fa-f\s]*>"         # hex string
    rb"|/[^\s\[\]()<>/]*"         # name
    rb"|[\[\]]"
    rb"|[-+.\d][-+.\deE]*"        # number
    rb"|[A-Za-z'\"*]+")           # operator


def _decode_string(tok: bytes) -> str:
    if tok.startswith(b"<"):
        hexs = re.sub(rb"\s", b"", tok[1:-1])
        if len(hexs) % 2:
            hexs += b"0"
        return bytes.fromhex(hexs.decode("ascii")).decode("latin-1")
    body = tok[1:-1]
    out = bytearray()
    i = 0
    esc = {b"n"[0]: 10, b"r"[0]: 13, b"t"[0]: 9, b"b"[0]: 8, b"f"[0]: 12}
    while i < len(body):
        c = body[i]
        if c == 0x5C and i + 1 < len(body):  # backslash
            n = body[i + 1]
            if n in esc:
                out.append(esc[n])
                i += 2
                continue
            if 0x30 <= n <= 0x37:  # octal
                j = i + 1
                oct_digits = b""
                while j < len(body) and len(oct_digits) < 3 and \
                        0x30 <= body[j] <= 0x37:
                    oct_digits += bytes([body[j]])
                    j += 1
                out.append(int(oct_digits, 8) & 0xFF)
                i = j
                continue
            out.append(n)
            i += 2
            continue
        out.append(c)
        i += 1
    return out.decode("latin-1")


class _Mat:
    """Row-vector 2D affine: [a b; c d; e f]."""

    __slots__ = ("a", "b", "c", "d", "e", "f")

    def __init__(self, a=1.0, b=0.0, c=0.0, d=1.0, e=0.0, f=0.0):
        self.a, self.b, self.c, self.d, self.e, self.f = a, b, c, d, e, f

    def mul(self, o: "_Mat") -> "_Mat":
        """self ∘ o (apply self first, then o)."""
        return _Mat(self.a * o.a + self.b * o.c,
                    self.a * o.b + self.b * o.d,
                    self.c * o.a + self.d * o.c,
                    self.c * o.b + self.d * o.d,
                    self.e * o.a + self.f * o.c + o.e,
                    self.e * o.b + self.f * o.d + o.f)

    def apply(self, x: float, y: float) -> Tuple[float, float]:
        return (self.a * x + self.c * y + self.e,
                self.b * x + self.d * y + self.f)

    def scale(self) -> float:
        import math
        return math.sqrt(abs(self.a * self.d - self.b * self.c)) or 1.0


def _paint_image(canvas: np.ndarray, arr: np.ndarray, ctm: "_Mat") -> bool:
    """Place a decoded image under the CTM (PDF maps the image onto the
    unit square of user space). Axis-aligned placements take the resize+
    paste fast path; rotated/skewed ones go through the inverse-affine
    transform with a mask."""
    h, w = arr.shape[:2]
    p00 = ctm.apply(0.0, 1.0)   # image top-left corner
    p10 = ctm.apply(1.0, 1.0)   # top-right
    p01 = ctm.apply(0.0, 0.0)   # bottom-left
    # device = p00 + (i/w)(p10-p00) + (j/h)(p01-p00); i = col, j = row
    M = np.array([
        [(p10[0] - p00[0]) / w, (p01[0] - p00[0]) / h, p00[0]],
        [(p10[1] - p00[1]) / w, (p01[1] - p00[1]) / h, p00[1]]])
    corners = [M @ [0, 0, 1], M @ [w, 0, 1], M @ [0, h, 1], M @ [w, h, 1]]
    xs = [c[0] for c in corners]
    ys = [c[1] for c in corners]
    H, W = canvas.shape[:2]
    bx0 = max(0, int(np.floor(min(xs))))
    by0 = max(0, int(np.floor(min(ys))))
    bx1 = min(W, int(np.ceil(max(xs))))
    by1 = min(H, int(np.ceil(max(ys))))
    bw, bh = bx1 - bx0, by1 - by0
    if bw <= 0 or bh <= 0:
        return False
    if abs(M[0, 1]) < 1e-9 and abs(M[1, 0]) < 1e-9 and M[0, 0] > 0 and \
            M[1, 1] > 0:
        pil_ops.paste(canvas, pil_ops.resize_bicubic(arr, (bw, bh)),
                      (bx0, by0))
        return True
    A = np.vstack([M, [0.0, 0.0, 1.0]])
    try:
        Ainv = np.linalg.inv(A)
    except np.linalg.LinAlgError:
        return False
    # the transform wants output(x,y) → input coeffs; output origin is bbox
    coeffs = (Ainv[0, 0], Ainv[0, 1],
              Ainv[0, 0] * bx0 + Ainv[0, 1] * by0 + Ainv[0, 2],
              Ainv[1, 0], Ainv[1, 1],
              Ainv[1, 0] * bx0 + Ainv[1, 1] * by0 + Ainv[1, 2])
    timg = pil_ops.transform_affine(arr, (bw, bh), coeffs, "bilinear")
    mask = pil_ops.transform_affine(np.full((h, w), 255, np.uint8),
                                    (bw, bh), coeffs, "nearest")
    pil_ops.paste(canvas, timg, (bx0, by0), mask)
    return True


def _ink(fill) -> Tuple[int, int, int]:
    """An RGB fill as PIL's getink takes it: each channel clipped to
    0..255."""
    return tuple(min(max(int(v), 0), 255) for v in fill)


def render_pdf_pages(pdf_path: str, dpi: int = 150) -> List[np.ndarray]:
    """Rasterize each page to an RGB uint8 array. Raises RuntimeError when
    no page produced any content (caller falls back / reports)."""
    with open(pdf_path, "rb") as fh:
        objs = _Objects(fh.read())
    page_nums = _find_pages(objs)
    if not page_nums:
        raise RuntimeError(f"{pdf_path}: no page objects found")

    scale0 = dpi / 72.0
    font_cache: Dict[Tuple[str, bool, int], font_mod.FreeTypeFont] = {}

    def get_font(family: str, bold: bool, px: int):
        px = max(4, min(px, 400))
        key = (family, bold, px)
        if key not in font_cache:
            path = _FONT_FILES.get((family, bold)) or \
                _FONT_FILES[("sans", False)]
            font_cache[key] = font_mod.FreeTypeFont(path, px)
        return font_cache[key]

    pages: List[np.ndarray] = []
    drew_anything = False
    image_cache: Dict[int, Optional[np.ndarray]] = {}
    for pnum in page_nums:
        w_pt, h_pt = _media_box(objs, pnum)
        W, H = int(w_pt * scale0) or 1, int(h_pt * scale0) or 1
        img = pil_ops.new((W, H), (255, 255, 255))
        fonts = _page_fonts(objs, pnum)
        xobjects = _page_xobjects(objs, pnum)

        # gather content stream(s)
        head, _ = objs.by_num.get(pnum, (b"", None))
        content = b""
        cm_arr = re.search(rb"/Contents\s*\[(.*?)\]", head, re.S)
        refs = cm_arr.group(1) if cm_arr else head
        cm_one = re.finditer(rb"(\d+)\s+\d+\s+R", refs) if cm_arr else \
            re.finditer(rb"/Contents\s+(\d+)\s+\d+\s+R", head)
        for m in cm_one:
            s = objs.stream_of(int(m.group(1)))
            if s:
                content += s + b"\n"
        if not content:
            pages.append(img)
            continue

        # device transform: PDF user space (y up) → pixels (y down)
        base = _Mat(scale0, 0.0, 0.0, -scale0, 0.0, H)
        ctm = base
        stack: List[_Mat] = []
        fill = (0, 0, 0)
        cur_font = ("sans", False)
        font_size = 12.0
        tm = _Mat()
        tlm = _Mat()
        leading = 0.0
        rects: List[Tuple[float, float, float, float]] = []
        operands: List = []

        def show_text(s: str):
            nonlocal tm, drew_anything
            if not s.strip():
                adv = get_font(*cur_font, 12).getlength(s) / 12.0
                tm = _Mat(1, 0, 0, 1, adv * font_size, 0).mul(tm)
                return
            trm = _Mat(font_size, 0, 0, font_size, 0, 0).mul(tm).mul(ctm)
            px = max(1, int(round(trm.scale())))
            font = get_font(cur_font[0], cur_font[1], px)
            x, y = trm.apply(0.0, 0.0)
            asc, _desc = font.getmetrics()
            font_mod.draw_text(img, (x, y - asc), s, _ink(fill), font)
            drew_anything = True
            adv = font.getlength(s) / px  # text-space ems
            tm = _Mat(1, 0, 0, 1, adv * font_size, 0).mul(tm)

        for tok in _TOKEN_RE.finditer(content):
            t = tok.group(0)
            c0 = t[:1]
            if c0 in b"([<" or c0.isdigit() or c0 in b"-+." or t in \
                    (b"[", b"]"):
                if t == b"[":
                    operands.append("[")
                elif t == b"]":
                    # collapse array elements into one list operand
                    arr = []
                    while operands and operands[-1] != "[":
                        arr.append(operands.pop())
                    if operands:
                        operands.pop()
                    operands.append(list(reversed(arr)))
                elif c0 in b"(<":
                    operands.append(_decode_string(t))
                else:
                    try:
                        operands.append(float(t))
                    except ValueError:
                        operands.append(0.0)
                continue
            if c0 == b"/":
                operands.append(t[1:])
                continue

            op = t
            try:
                if op == b"q":
                    stack.append(ctm)
                elif op == b"Q":
                    ctm = stack.pop() if stack else base
                elif op == b"cm" and len(operands) >= 6:
                    a, b_, c, d, e, f = operands[-6:]
                    ctm = _Mat(a, b_, c, d, e, f).mul(ctm)
                elif op == b"g" and operands:
                    v = int(float(operands[-1]) * 255)
                    fill = (v, v, v)
                elif op == b"rg" and len(operands) >= 3:
                    fill = tuple(int(float(v) * 255)
                                 for v in operands[-3:])
                elif op == b"BT":
                    tm = _Mat()
                    tlm = _Mat()
                elif op == b"Tf" and len(operands) >= 2:
                    name = operands[-2]
                    font_size = float(operands[-1])
                    if isinstance(name, bytes):
                        cur_font = fonts.get(name, ("sans", False))
                elif op == b"TL" and operands:
                    leading = float(operands[-1])
                elif op in (b"Td", b"TD") and len(operands) >= 2:
                    tx, ty = operands[-2:]
                    if op == b"TD":
                        leading = -float(ty)
                    tlm = _Mat(1, 0, 0, 1, float(tx), float(ty)).mul(tlm)
                    tm = tlm
                elif op == b"Tm" and len(operands) >= 6:
                    a, b_, c, d, e, f = (float(v) for v in operands[-6:])
                    tlm = _Mat(a, b_, c, d, e, f)
                    tm = tlm
                elif op == b"T*":
                    tlm = _Mat(1, 0, 0, 1, 0, -leading).mul(tlm)
                    tm = tlm
                elif op == b"Tj" and operands:
                    show_text(str(operands[-1]))
                elif op == b"'" and operands:
                    tlm = _Mat(1, 0, 0, 1, 0, -leading).mul(tlm)
                    tm = tlm
                    show_text(str(operands[-1]))
                elif op == b"TJ" and operands and \
                        isinstance(operands[-1], list):
                    for el in operands[-1]:
                        if isinstance(el, str):
                            show_text(el)
                        else:  # kerning adjustment, thousandths of em
                            tm = _Mat(1, 0, 0, 1,
                                      -float(el) / 1000.0 * font_size,
                                      0).mul(tm)
                elif op == b"re" and len(operands) >= 4:
                    rects.append(tuple(float(v) for v in operands[-4:]))
                elif op in (b"f", b"f*", b"F", b"b", b"B", b"b*", b"B*"):
                    for (rx, ry, rw, rh) in rects:
                        x0, y0 = ctm.apply(rx, ry)
                        x1, y1 = ctm.apply(rx + rw, ry + rh)
                        pil_ops.rectangle(img, (min(x0, x1), min(y0, y1),
                                                max(x0, x1), max(y0, y1)),
                                          _ink(fill))
                        if abs(x1 - x0) > 2 and abs(y1 - y0) > 2:
                            drew_anything = True
                    rects = []
                elif op == b"n":
                    rects = []
                elif op == b"Do" and operands:
                    name = operands[-1]
                    onum = xobjects.get(name) if isinstance(name, bytes) \
                        else None
                    if onum is not None:
                        if onum not in image_cache:
                            image_cache[onum] = _decode_image_xobject(
                                objs, onum)
                        arr = image_cache[onum]
                        if arr is not None and _paint_image(img, arr, ctm):
                            drew_anything = True
            except Exception:
                pass  # malformed operator sequences are skipped, not fatal
            operands = []

        pages.append(img)

    if not drew_anything:
        raise RuntimeError(
            f"{pdf_path}: no drawable text/rect content found "
            "(image-only or unsupported constructs)")
    return pages
