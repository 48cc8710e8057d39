"""Lossless JPEG (SOF3) in the port's JPEG decoder
(onnxocr_tpu_torch/csrc/host/imcodec.cc) against cv2 5.0 on the CPU.

The files come from the numpy encoder below (Huffman, one table, one
interleaved scan): every predictor 1-7, point transforms, restart
intervals (the predictor starts over at each), 3 components with IDs 1, 2,
3 and 'R', 'G', 'B' (libjpeg-turbo takes both as RGB in lossless mode),
4-component CMYK, subsampled components (replicated, not fancy-upsampled),
sample precisions 2-8. Each decodes value-equal to
`cv2.imdecode(buf, cv2.IMREAD_COLOR)`. cv2 gives None, and so does the
port, where libjpeg-turbo would have to convert colour spaces in lossless
mode (grey to BGR, a JFIF marker's or an Adobe transform's YCbCr or YCCK),
for precision 12 and 16, arithmetic-coded lossless (SOF11), hierarchical
frames (SOF5-7), a restart interval that is not a whole number of MCU rows,
a component twice in the scan, and every cut; seeded mutants, and frames
and scans of repeated or reordered component IDs, answer as cv2 does.
"""
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from onnxocr_tpu_torch.utils import imcodec


# the standard luminance DC table (categories 0-11) with categories 12-16
# at lengths 10-14, so that every difference has a code
LL_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0]
LL_VALS = list(range(17))


def _codes(bits, vals):
    code, k, out = 0, 0, {}
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _diffs(v, predictor, precision, pt, first_rows):
    """Sample differences of one component (dh, dw) as the encoder forms
    them; `first_rows(y)` says whether row y starts the scan or a restart
    interval."""
    v = v.astype(np.int64)
    pred = np.zeros_like(v)
    for y in range(v.shape[0]):
        if first_rows(y):
            pred[y, 0] = 1 << (precision - pt - 1)
            pred[y, 1:] = v[y, :-1]
            continue
        ra, rb = v[y, :-1], v[y - 1, 1:]
        rc = v[y - 1, :-1]
        pred[y, 0] = v[y - 1, 0]
        pred[y, 1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                       5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                       7: (ra + rb) >> 1}[predictor]
    d = (v - pred) & 0xFFFF
    return np.where(d >= 32768, d - 65536, d)


def lossless_jpeg(planes, precision=8, predictor=1, pt=0, restart_rows=0,
                  ids=None, sampling=None, marker=0xC3, app=b""):
    """A lossless JPEG (SOF3, one Huffman table, one interleaved scan) of
    component planes whose values are the coded ones (the decoder shifts
    them left by `pt`). sampling: (h, v) a component; every plane must be
    its component's size. restart_rows: MCU rows a restart interval."""
    nc = len(planes)
    ids = ids or list(range(1, nc + 1))
    sampling = sampling or [(1, 1)] * nc
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    h = max(p.shape[0] * vmax // s[1] for p, s in zip(planes, sampling))
    w = max(p.shape[1] * hmax // s[0] for p, s in zip(planes, sampling))
    single = nc == 1
    mcux = planes[0].shape[1] if single else -(-w // hmax)
    mcuy = planes[0].shape[0] if single else -(-h // vmax)
    diffs = []
    for p, (hs, vs) in zip(planes, sampling):
        unit_rows = 1 if single else vs
        first = (lambda y, u=unit_rows: y == 0 or (restart_rows and
                 y % (u * restart_rows) == 0))
        d = _diffs(p, predictor, precision, pt, first)
        nv, nh = (1, 1) if single else (vs, hs)
        full = np.zeros((mcuy * nv, mcux * nh), np.int64)
        full[:d.shape[0], :d.shape[1]] = d
        diffs.append((full, nh, nv))
    codes = _codes(LL_BITS, LL_VALS)
    out, acc, nbits = bytearray(), 0, 0

    def put(value, n):
        nonlocal acc, nbits
        acc, nbits = (acc << n) | (value & ((1 << n) - 1)), nbits + n
        while nbits >= 8:
            nbits -= 8
            byte = (acc >> nbits) & 255
            out.append(byte)
            if byte == 0xFF:
                out.append(0)

    def flush():
        nonlocal nbits
        if nbits:
            put((1 << (8 - nbits)) - 1, 8 - nbits)
    rst = 0
    for my in range(mcuy):
        if restart_rows and my and my % restart_rows == 0:
            flush()
            out += bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) & 7
        for mx in range(mcux):
            for full, nh, nv in diffs:
                for yy in range(nv):
                    for xx in range(nh):
                        d = int(full[my * nv + yy, mx * nh + xx])
                        s = 16 if d == -32768 else abs(d).bit_length()
                        code, length = codes[s]
                        put(code, length)
                        if 0 < s < 16:
                            put(d if d > 0 else d + (1 << s) - 1, s)
    flush()

    def seg(m, body):
        return bytes([0xFF, m]) + struct.pack(">H", len(body) + 2) + body
    sof = struct.pack(">BHHB", precision, h, w, nc) + b"".join(
        bytes([i, (hs << 4) | vs, 0]) for i, (hs, vs) in zip(ids, sampling))
    dht = bytes([0x00]) + bytes(LL_BITS) + bytes(LL_VALS)
    sos = bytes([nc]) + b"".join(bytes([i, 0]) for i in ids) + bytes(
        [predictor, 0, pt])
    dri = seg(0xDD, struct.pack(">H", restart_rows * mcux)) \
        if restart_rows else b""
    return (b"\xff\xd8" + app + seg(marker, sof) + seg(0xC4, dht) + dri +
            seg(0xDA, sos) + bytes(out) + b"\xff\xd9")


REPO = Path(__file__).resolve().parents[1]
ADOBE = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00"
JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


def answers_as_cv2(blob):
    want = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
    got = imcodec.imdecode(blob)
    if want is None:
        assert got is None
        return "none"
    assert got is not None and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return "decoded"


def page_planes(h=50, w=70):
    img = cv2.imread(str(REPO / "onnxocr_tpu" / "test_images" / "card.jpg"))
    return [img[:h, :w, i].astype(np.int64) for i in range(3)]


LAYOUTS = {
    "ids-123": {},
    "ids-rgb": {"ids": [82, 71, 66]},
    "pt-2": {"pt": 2},
    "restart-3": {"restart_rows": 3},
    "h2v2": {"sampling": [(2, 2), (1, 1), (1, 1)]},
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_matches_cv2(predictor, layout):
    """Each predictor on a corpus crop and on seeded noise (differences of
    every category up to 8 bits), at each layout."""
    kw = dict(LAYOUTS[layout])
    rng = np.random.default_rng(predictor)
    for planes in (page_planes(), [rng.integers(0, 256, (23, 37))
                                   for _ in range(3)]):
        pt = kw.get("pt", 0)
        planes = [p >> pt for p in planes]
        if "sampling" in kw:
            planes = [planes[0]] + [p[::2, ::2] for p in planes[1:]]
        blob = lossless_jpeg(planes, predictor=predictor, **kw)
        assert answers_as_cv2(blob) == "decoded"


@pytest.mark.parametrize("precision", [2, 5, 7])
def test_lossless_low_precision_matches_cv2(precision):
    """Precisions below 8 through the 8-bit interface: the samples as
    coded (shifted by Pt), not scaled."""
    planes = [p >> (8 - precision) for p in page_planes(31, 45)]
    for pt in (0, 1):
        blob = lossless_jpeg([p >> pt for p in planes], precision=precision,
                             predictor=7, pt=pt)
        assert answers_as_cv2(blob) == "decoded"


def _refused():
    planes = page_planes(20, 30)
    grey = planes[:1]
    bad_dri = lossless_jpeg(planes, restart_rows=2)
    i = bad_dri.index(b"\xff\xdd")
    bad_dri = bad_dri[:i + 4] + b"\x00\x1d" + bad_dri[i + 6:]
    return {
        "grey": lossless_jpeg(grey), "jfif-ycc": lossless_jpeg(planes,
                                                              app=JFIF),
        "adobe-ycc": lossless_jpeg(planes, app=ADOBE + b"\x01"),
        "adobe-ycck": lossless_jpeg(planes + planes[:1], app=ADOBE + b"\x02"),
        "precision-12": lossless_jpeg(planes, precision=12),
        "precision-16": lossless_jpeg(planes, precision=16),
        "sof11": lossless_jpeg(planes, marker=0xCB),
        "sof5": lossless_jpeg(planes, marker=0xC5),
        "sof6": lossless_jpeg(planes, marker=0xC6),
        "sof7": lossless_jpeg(planes, marker=0xC7),
        "restart-not-a-row": bad_dri,
        "two-components": lossless_jpeg(planes[:2]),
    }


@pytest.mark.parametrize("case", list(_refused()))
def test_lossless_refused_as_cv2(case):
    """What cv2 5.0 gives None for gives None here."""
    assert answers_as_cv2(_refused()[case]) == "none"


def test_lossless_accepted_colour_spaces_match_cv2():
    """CMYK (four components, no Adobe marker or transform 0) and RGB
    under Adobe's transform 0 decode as stored."""
    planes = page_planes(20, 30)
    for blob in (lossless_jpeg(planes + planes[:1]),
                 lossless_jpeg(planes + planes[:1], app=ADOBE + b"\x00"),
                 lossless_jpeg(planes, app=ADOBE + b"\x00")):
        assert answers_as_cv2(blob) == "decoded"


def _with_ids(blob, sof_ids, scan_ids):
    """The file with its frame's and its scan's component IDs rewritten."""
    b = bytearray(blob)
    sof = max(b.find(b"\xff\xc0"), b.find(b"\xff\xc3"))
    sos = b.index(b"\xff\xda")
    for k, (f, s) in enumerate(zip(sof_ids, scan_ids)):
        b[sof + 10 + 3 * k], b[sos + 5 + 2 * k] = f, s
    return bytes(b)


@pytest.mark.parametrize("kind", ["lossless", "baseline"])
def test_scan_component_ids_answer_as_cv2(kind):
    """Every frame and scan of IDs drawn from 1-3 (repeated, reordered):
    libjpeg-turbo takes for each scan position the first component of
    that ID at or after it, and a component twice in one scan gives None;
    the rest decode as cv2 decodes them."""
    import itertools
    planes = page_planes(16, 24)
    blob = lossless_jpeg(planes, predictor=1) if kind == "lossless" else \
        bytes(cv2.imencode(".jpg", np.dstack(planes).astype(np.uint8))[1])
    grid = list(itertools.product(range(1, 4), repeat=3))
    verdicts = [answers_as_cv2(_with_ids(blob, f, s))
                for f in grid for s in grid]
    assert verdicts.count("decoded") == 27


def test_lossless_cuts_and_mutants_answer_as_cv2():
    """Every tenth cut of a file with restarts (cv2: None), and 80 seeded
    mutants of 1-3 bytes (bad codes, broken restarts, differences running
    the predictor past 8 bits: the low byte of the sample shifted by Pt)."""
    blob = lossless_jpeg(page_planes(40, 60), predictor=4, restart_rows=5,
                         pt=1)
    for cut in range(20, len(blob) - 1, max(1, len(blob) // 10)):
        assert answers_as_cv2(blob[:cut]) == "none"
    rng = np.random.default_rng(80)
    verdicts = []
    for _ in range(80):
        b = bytearray(blob)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(2, len(b)))
            b[i] = int(rng.integers(256)) if rng.random() < 0.5 else \
                b[i] ^ (1 << int(rng.integers(8)))
        verdicts.append(answers_as_cv2(bytes(b)))
    assert verdicts.count("decoded") > 40
