"""Lossless JPEG (SOF3) in the port's JPEG decoder
(onnxocr_tpu_torch/csrc/host/imcodec.cc) against cv2 5.0 on the CPU.

The files come from the numpy encoder below (Huffman, one table, one
interleaved scan or several scans of any components): every predictor
1-7, point transforms, restart intervals (the predictor starts over at
each), 3 components with IDs 1, 2, 3 and 'R', 'G', 'B' (libjpeg-turbo
takes both as RGB in lossless mode), 4-component CMYK, subsampled
components (replicated, not fancy-upsampled), sample precisions 2-8; in
several scans, a scan a component or a component and then the other two,
each scan with its own predictor, point transform and restarts, a
component scanned twice (the later scan's samples stay). Each decodes
value-equal to
`cv2.imdecode(buf, cv2.IMREAD_COLOR)`. cv2 gives None, and so does the
port, where libjpeg-turbo would have to convert colour spaces in lossless
mode (grey to BGR, a JFIF marker's or an Adobe transform's YCbCr or YCCK),
for precision 12 and 16, arithmetic-coded lossless (SOF11), hierarchical
frames (SOF5-7), a restart interval that is not a whole number of MCU rows,
a component twice in the scan, a component no scan names, and every cut;
seeded mutants, and frames
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
                  ids=None, sampling=None, marker=0xC3, app=b"", scans=None):
    """A lossless JPEG (SOF3, one Huffman table) of component planes whose
    values are the coded ones (the decoder shifts them left by the scan's
    point transform). sampling: (h, v) a component; every plane must be
    its component's size. restart_rows: MCU rows a restart interval (a DRI
    before each scan). scans: the component indices of each scan (default
    one interleaved scan of all); predictor and pt may then be a list, one
    value a scan."""
    nc = len(planes)
    ids = ids or list(range(1, nc + 1))
    sampling = sampling or [(1, 1)] * nc
    scans = scans or [list(range(nc))]
    predictors = predictor if isinstance(predictor, list) else \
        [predictor] * len(scans)
    pts = pt if isinstance(pt, list) else [pt] * len(scans)
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    # the frame's size: that of the components of the largest factors
    h = max(p.shape[0] for p, s in zip(planes, sampling) if s[1] == vmax)
    w = max(p.shape[1] for p, s in zip(planes, sampling) if s[0] == hmax)
    codes = _codes(LL_BITS, LL_VALS)

    def seg(m, body):
        return bytes([0xFF, m]) + struct.pack(">H", len(body) + 2) + body
    body = b""
    for comps, predictor, pt in zip(scans, predictors, pts):
        single = len(comps) == 1
        mcux = planes[comps[0]].shape[1] if single else -(-w // hmax)
        mcuy = planes[comps[0]].shape[0] if single else -(-h // vmax)
        diffs = []
        for c in comps:
            hs, vs = sampling[c]
            unit_rows = 1 if single else vs
            first = (lambda y, u=unit_rows: y == 0 or (restart_rows and
                     y % (u * restart_rows) == 0))
            d = _diffs(planes[c], predictor, precision, pt, first)
            nv, nh = (1, 1) if single else (vs, hs)
            full = np.zeros((mcuy * nv, mcux * nh), np.int64)
            full[:d.shape[0], :d.shape[1]] = d
            diffs.append((full, nh, nv))
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
        sos = bytes([len(comps)]) + b"".join(
            bytes([ids[c], 0]) for c in comps) + bytes([predictor, 0, pt])
        dri = seg(0xDD, struct.pack(">H", restart_rows * mcux)) \
            if restart_rows else b""
        body += dri + seg(0xDA, sos) + bytes(out)
    sof = struct.pack(">BHHB", precision, h, w, nc) + b"".join(
        bytes([i, (hs << 4) | vs, 0]) for i, (hs, vs) in zip(ids, sampling))
    dht = bytes([0x00]) + bytes(LL_BITS) + bytes(LL_VALS)
    return (b"\xff\xd8" + app + seg(marker, sof) + seg(0xC4, dht) + body +
            b"\xff\xd9")


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
        "a-component-unscanned": lossless_jpeg(planes, scans=[[0], [1]]),
        "scans-without-eoi": lossless_jpeg(planes, scans=[[0], [1], [2]])[:-2],
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
    """Every tenth cut of a file with restarts, in one scan and in a scan a
    component (cv2: None), and 80 seeded mutants of each, of 1-3 bytes
    (bad codes, broken restarts, differences running the predictor past 8
    bits: the low byte of the sample shifted by Pt)."""
    blob = lossless_jpeg(page_planes(40, 60), predictor=4, restart_rows=5,
                         pt=1)
    multi = lossless_jpeg(page_planes(40, 60), predictor=[4, 2, 7],
                          restart_rows=5, pt=1, scans=[[0], [1], [2]])
    for b in (blob, multi):
        for cut in range(20, len(b) - 1, max(1, len(b) // 10)):
            assert answers_as_cv2(b[:cut]) == "none"
    rng = np.random.default_rng(80)
    verdicts = []
    for b0 in (blob, multi):
        for _ in range(80):
            b = bytearray(b0)
            for _ in range(int(rng.integers(1, 4))):
                i = int(rng.integers(2, len(b)))
                b[i] = int(rng.integers(256)) if rng.random() < 0.5 else \
                    b[i] ^ (1 << int(rng.integers(8)))
            verdicts.append(answers_as_cv2(bytes(b)))
    assert verdicts.count("decoded") > 80


SCANS = {"per-component": [[0], [1], [2]], "first-then-two": [[0], [1, 2]],
         "two-then-first": [[1, 2], [0]]}
MULTI = {
    "plain": {},
    "pt": {"pt": [1, 0, 2]},
    "restart-2": {"restart_rows": 2},
    "h2v2-first": {"sampling": [(2, 2), (1, 1), (1, 1)]},
    "h2v2-second-third": {"sampling": [(1, 1), (2, 2), (2, 2)]},
}


def _scan_planes(planes, kw, scans):
    """The planes cut to their sampling and shifted by the point transform
    of the scan that codes them."""
    pts = kw.get("pt", [0] * len(scans))
    out = list(planes)
    for comps, pt in zip(scans, pts):
        for c in comps:
            out[c] = out[c] >> pt
    hmax = max(h for h, _ in kw.get("sampling", [(1, 1)]))
    vmax = max(v for _, v in kw.get("sampling", [(1, 1)]))
    for c, (h, v) in enumerate(kw.get("sampling", [])):
        out[c] = out[c][::vmax // v, ::hmax // h]
    return out


@pytest.mark.parametrize("variant", list(MULTI))
@pytest.mark.parametrize("layout", list(SCANS))
def test_lossless_scans_match_cv2(layout, variant):
    """Frames of several scans: a scan a component, or one and then the
    other two, each at the variant's point transforms, restarts (a
    single-component scan's interval counts its own rows) or subsampling,
    on a corpus crop and on seeded noise."""
    scans, kw = SCANS[layout], dict(MULTI[variant])
    if "pt" in kw:
        kw["pt"] = kw["pt"][:len(scans)]
    rng = np.random.default_rng(len(layout) * 7 + len(variant))
    for planes in (page_planes(), [rng.integers(0, 256, (23, 37))
                                   for _ in range(3)]):
        blob = lossless_jpeg(_scan_planes(planes, kw, scans), scans=scans,
                             **kw)
        assert answers_as_cv2(blob) == "decoded"


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_predictor_per_scan_matches_cv2(predictor):
    """A scan a component, each with its own predictor (the three
    predictors that follow `predictor`), with and without restarts."""
    ps = [predictor, predictor % 7 + 1, (predictor + 1) % 7 + 1]
    for restart in (0, 3):
        blob = lossless_jpeg(page_planes(), predictor=ps,
                             scans=[[0], [1], [2]], restart_rows=restart)
        assert answers_as_cv2(blob) == "decoded"


def test_lossless_four_components_and_rescans_match_cv2():
    """CMYK in four scans and in two scans of two; a component scanned a
    second time with other samples and another predictor (libjpeg's
    full-image buffer keeps the later scan's rows)."""
    planes = page_planes(20, 30)
    for scans in ([[0], [1], [2], [3]], [[0, 1], [2, 3]]):
        assert answers_as_cv2(lossless_jpeg(planes + planes[:1],
                                            scans=scans)) == "decoded"
    blob = lossless_jpeg(planes, scans=[[0], [1], [2]])
    again = lossless_jpeg([255 - planes[0]] + planes[1:], scans=[[0]],
                          predictor=6)
    sos = again.index(b"\xff\xda")
    rescanned = blob[:-2] + again[sos:]
    assert answers_as_cv2(rescanned) == "decoded"
    assert (imcodec.imdecode(rescanned) != imcodec.imdecode(blob)).any()
