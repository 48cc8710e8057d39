"""JPEG 2000 in the port's image codec (onnxocr_tpu_torch/utils/imcodec.py,
C++ in csrc/host/jpeg2000.cc built with g++) against cv2 5.0, which reads
it through OpenJPEG 2.5, on the CPU.

Files are written here by PIL (OpenJPEG's encoder) at sizes up to 96 x 128:
reversible and irreversible, JP2 and bare codestreams, L, LA, RGB, RGBA and
16-bit grey, odd sizes, tiles whose origins are odd, precincts, small and
flat code-blocks, the five progression orders with several quality layers,
PLT and comment segments, with and without the colour transform. JP2 boxes
PIL does not write are built by hand: a palette with its component
mapping, channel definitions that reorder the colours, the colour spaces
cv2 converts (sYCC), reads as grey or sRGB (an unknown enumeration, ICC)
or refuses (CMYK, e-sYCC). `imdecode` equals `cv2.imdecode(buf,
cv2.IMREAD_COLOR)` value for value on every case, and gives None where cv2
does (signed components, an image offset, a bare grey codestream, every
truncation but the ones OpenJPEG forgives), ValueError where cv2 raises (a
side past 2^20); seeded mutants give cv2's verdict and pixels, and decode
without a fault in a build with AddressSanitizer. A tiled 2048 x 2048
file decodes within its output plus 48 MB of peak RSS.
"""
import io
import os
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from onnxocr_tpu_torch.ops import native
from onnxocr_tpu_torch.utils import imcodec

_SAMPLES = Path(__file__).resolve().parents[1] / "onnxocr_tpu_torch" / \
    "assets" / "samples"


def _cv2(blob):
    return cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)


def assert_answers_as_cv2(blob):
    """cv2's answer for any bytes: its image value for value, None, or
    an error (ValueError here)."""
    try:
        want = _cv2(blob)
    except cv2.error:
        with pytest.raises(ValueError):
            imcodec.imdecode(blob)
        return "raised"
    got = imcodec.imdecode(blob)
    if want is None:
        assert got is None
        return "none"
    assert got is not None and got.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return "decoded"


def _encode(im, **kw):
    buf = io.BytesIO()
    im.save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def _pixels(h, w, channels, seed, smooth=True):
    """A seeded image: blurred noise with edges (smooth) or plain noise."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w, channels)).astype(np.uint8)
    if smooth:
        a = cv2.GaussianBlur(a, (0, 0), 1.5).reshape(h, w, channels)
        a[h // 3:h // 3 + 2] = 255 - a[h // 3:h // 3 + 2]
    return a


def _image(mode, h, w, seed, smooth=True):
    if mode == "I;16":
        v = np.random.default_rng(seed).integers(0, 65536, (h, w))
        v = v.astype(np.uint16)
        if smooth:
            v = cv2.GaussianBlur(v, (0, 0), 1.5)
        return Image.fromarray(v)
    n = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    a = _pixels(h, w, n, seed, smooth)
    return Image.fromarray(a[:, :, 0] if n == 1 else a, mode)


def test_jp2_library_builds_from_the_repo():
    path = native.build(imcodec.JP2_SOURCE, "libocrjp2")
    assert path.parent == native.BUILD_DIR and path.name.startswith(
        "libocrjp2-") and path.exists()
    assert imcodec.jp2_lib() is imcodec.jp2_lib()


# (mode, height, width, PIL's JPEG 2000 options); every case is seeded
_LAYERS = dict(quality_mode="rates", quality_layers=[40, 20, 8])
_CASES = {
    "rev-jp2-rgb": ("RGB", 61, 83, {}),
    "irr-jp2-rgb": ("RGB", 61, 83, dict(irreversible=True)),
    "rev-j2k-rgb": ("RGB", 61, 83, dict(no_jp2=True)),
    "irr-j2k-rgb": ("RGB", 61, 83, dict(no_jp2=True, irreversible=True)),
    "rev-jp2-l": ("L", 64, 96, {}),
    "irr-jp2-l": ("L", 64, 96, dict(irreversible=True)),
    "rev-j2k-l-none": ("L", 64, 96, dict(no_jp2=True)),
    "rev-jp2-la": ("LA", 50, 70, {}),
    "irr-jp2-la": ("LA", 50, 70, dict(irreversible=True)),
    "rev-j2k-la-none": ("LA", 50, 70, dict(no_jp2=True)),
    "rev-jp2-rgba": ("RGBA", 47, 65, {}),
    "irr-j2k-rgba": ("RGBA", 47, 65, dict(no_jp2=True, irreversible=True)),
    "rev-jp2-grey16": ("I;16", 45, 77, {}),
    "irr-jp2-grey16": ("I;16", 45, 77, dict(irreversible=True)),
    "rev-j2k-grey16-none": ("I;16", 45, 77, dict(no_jp2=True)),
    "odd-1x1": ("RGB", 1, 1, {}),
    "odd-1x97": ("RGB", 1, 97, {}),
    "odd-95x1": ("L", 95, 1, {}),
    "odd-3x5-irr": ("RGB", 3, 5, dict(irreversible=True)),
    "odd-93x127-irr": ("RGB", 93, 127, dict(irreversible=True)),
    "tiles-17x23": ("RGB", 96, 128, dict(tile_size=(17, 23))),
    "tiles-13x13-irr": ("RGB", 96, 128, dict(tile_size=(13, 13),
                                            irreversible=True)),
    "tiles-one-wide": ("RGB", 35, 18, dict(tile_size=(17, 17))),
    "tiles-31x29-j2k-irr": ("RGB", 90, 120, dict(
        tile_size=(31, 29), no_jp2=True, irreversible=True)),
    "precincts-16x32": ("RGB", 96, 128, dict(precinct_size=(16, 32),
                                             num_resolutions=4)),
    "precincts-32x16-irr": ("RGB", 96, 128, dict(
        precinct_size=(32, 16), codeblock_size=(8, 8), irreversible=True,
        num_resolutions=4)),
    "precincts-64x64": ("RGB", 96, 128, dict(precinct_size=(64, 64))),
    "cblk-4x4": ("L", 40, 56, dict(codeblock_size=(4, 4))),
    "cblk-4x64": ("RGB", 70, 90, dict(codeblock_size=(4, 64))),
    "cblk-64x4-irr": ("RGB", 70, 90, dict(codeblock_size=(64, 4),
                                          irreversible=True)),
    "lrcp-layers": ("RGB", 96, 128, dict(progression="LRCP",
                                         precinct_size=(16, 16),
                                         num_resolutions=4, **_LAYERS)),
    "rlcp-layers": ("RGB", 96, 128, dict(progression="RLCP",
                                         precinct_size=(16, 16),
                                         num_resolutions=4, **_LAYERS)),
    "rpcl-layers": ("RGB", 96, 128, dict(progression="RPCL",
                                         precinct_size=(16, 32),
                                         num_resolutions=4, **_LAYERS)),
    "pcrl-layers-irr": ("RGB", 96, 128, dict(
        progression="PCRL", precinct_size=(32, 16), irreversible=True,
        tile_size=(40, 50), num_resolutions=4, **_LAYERS)),
    "cprl-layers": ("RGBA", 96, 128, dict(progression="CPRL",
                                          precinct_size=(32, 32), **_LAYERS)),
    "cprl-small-precincts-none": ("RGB", 96, 128, dict(
        progression="CPRL", precinct_size=(16, 16), **_LAYERS)),
    "db-layers-irr": ("RGB", 96, 128, dict(irreversible=True, quality_mode="dB",
                                           quality_layers=[24, 32, 45])),
    "one-resolution": ("RGB", 48, 64, dict(num_resolutions=1)),
    "seven-resolutions-irr": ("RGB", 96, 128, dict(num_resolutions=7,
                                                   irreversible=True)),
    "no-mct-irr": ("RGB", 48, 64, dict(mct=0, irreversible=True)),
    "plt-comment": ("RGB", 48, 64, dict(plt=True, comment="a comment")),
    "noise-irr": ("RGB", 40, 40, dict(irreversible=True)),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_pil_files_decode_as_cv2(case):
    """PIL's file of each case: cv2's pixels, or None where cv2 gives None
    (the `-none` cases: a bare codestream's unknown colour space is read
    as sRGB, which needs three components; precincts that PIL halves below
    one sample at the low resolutions)."""
    mode, h, w, kw = _CASES[case]
    smooth = not case.startswith("noise")
    blob = _encode(_image(mode, h, w, seed=len(case) * 7 + h, smooth=smooth),
                   **kw)
    verdict = assert_answers_as_cv2(blob)
    assert verdict == ("none" if case.endswith("-none") else "decoded")


def test_signed_and_offset_files_are_none():
    """cv2 refuses signed components (readHeader) and an image origin
    other than 0 (readData's per-component checks)."""
    im = _image("RGB", 40, 50, seed=3)
    for kw in (dict(signed=True), dict(offset=(5, 7), tile_offset=(3, 5),
                                       tile_size=(16, 16))):
        blob = _encode(im, **kw)
        assert _cv2(blob) is None
        assert imcodec.imdecode(blob) is None


# ------------------------------------------------------- hand-built boxes
def _box(kind, body):
    return struct.pack(">I", 8 + len(body)) + kind + body


def _boxes(blob):
    out, pos = [], 0
    while pos < len(blob):
        n = struct.unpack(">I", blob[pos:pos + 4])[0] or len(blob) - pos
        out.append((blob[pos + 4:pos + 8], blob[pos + 8:pos + n]))
        pos += n
    return out


def _with_jp2h(blob, edit):
    """The JP2 file `blob` with its jp2h sub-boxes replaced by
    edit(list of (type, body))."""
    out = b""
    for kind, body in _boxes(blob):
        if kind == b"jp2h":
            body = b"".join(_box(k, b) for k, b in edit(_boxes(body)))
        out += _box(kind, body)
    return out


def _colr(enumcs=None, icc=None):
    if icc is not None:
        return b"\x02\x00\x00" + icc
    return b"\x01\x00\x00" + struct.pack(">I", enumcs)


def _set_colr(body):
    return lambda sub: [(k, body if k == b"colr" else b) for k, b in sub]


def _palette(lut, bits=8, cmap=True, enumcs=16):
    def edit(sub):
        sub = [(k, _colr(enumcs) if k == b"colr" else b) for k, b in sub]
        size = (bits + 7) // 8
        entries = b"".join(int(v).to_bytes(size, "big")
                           for row in lut for v in row)
        sub.append((b"pclr", struct.pack(">HB", len(lut), lut.shape[1]) +
                    bytes([bits - 1] * lut.shape[1]) + entries))
        if cmap:
            sub.append((b"cmap", b"".join(struct.pack(">HBB", 0, 1, i)
                                          for i in range(lut.shape[1]))))
        return sub
    return edit


def _cdef(entries):
    body = struct.pack(">H", len(entries)) + b"".join(
        struct.pack(">HHH", *e) for e in entries)
    return lambda sub: sub + [(b"cdef", body)]


def _box_cases():
    rng = np.random.default_rng(41)
    idx = _encode(Image.fromarray(rng.integers(0, 16, (23, 31)).astype(
        np.uint8)))
    lut8 = rng.integers(0, 256, (16, 3))
    rgb = _encode(_image("RGB", 29, 37, seed=5))
    rgba = _encode(_image("RGBA", 29, 37, seed=6))
    grey = _encode(_image("L", 29, 37, seed=7))
    return {
        "pclr": (_with_jp2h(idx, _palette(lut8)), "decoded"),
        "pclr-16bit-entries": (_with_jp2h(idx, _palette(lut8 * 257, 16)),
                               "decoded"),
        "pclr-short-clamped": (_with_jp2h(idx, _palette(lut8[:12])),
                               "decoded"),
        "pclr-without-cmap": (_with_jp2h(idx, _palette(lut8, cmap=False,
                                                       enumcs=17)), "decoded"),
        "cdef-identity": (_with_jp2h(rgb, _cdef([(0, 0, 1), (1, 0, 2),
                                                 (2, 0, 3)])), "decoded"),
        "cdef-swap": (_with_jp2h(rgb, _cdef([(0, 0, 3), (1, 0, 2),
                                             (2, 0, 1)])), "decoded"),
        "cdef-rotate": (_with_jp2h(rgb, _cdef([(0, 0, 2), (1, 0, 3),
                                               (2, 0, 1)])), "decoded"),
        "cdef-alpha-first": (_with_jp2h(rgb, _cdef([(0, 1, 0), (1, 0, 2),
                                                    (2, 0, 3)])), "decoded"),
        "cdef-incomplete": (_with_jp2h(rgb, _cdef([(0, 0, 1), (1, 0, 2)])),
                            "none"),
        "cdef-bad-channel": (_with_jp2h(rgb, _cdef([(0, 0, 1), (1, 0, 2),
                                                    (5, 0, 3)])), "none"),
        "sycc": (_with_jp2h(rgb, _set_colr(_colr(18))), "decoded"),
        "sycc-rgba": (_with_jp2h(rgba, _set_colr(_colr(18))), "decoded"),
        "sycc-grey": (_with_jp2h(grey, _set_colr(_colr(18))), "none"),
        "grey-on-rgb": (_with_jp2h(rgb, _set_colr(_colr(17))), "decoded"),
        "srgb-on-grey": (_with_jp2h(grey, _set_colr(_colr(16))), "none"),
        "cmyk": (_with_jp2h(rgb, _set_colr(_colr(12))), "none"),
        "esycc": (_with_jp2h(rgb, _set_colr(_colr(24))), "none"),
        "unknown-enum": (_with_jp2h(rgb, _set_colr(_colr(99))), "decoded"),
        "icc": (_with_jp2h(rgb, _set_colr(_colr(icc=bytes(128)))), "decoded"),
        "no-colr": (_with_jp2h(rgb, lambda s: [(k, b) for k, b in s
                                                if k != b"colr"]), "decoded"),
        "second-colr-ignored": (_with_jp2h(rgb, lambda s: s + [
            (b"colr", _colr(17))]), "decoded"),
        "ihdr-size-differs": (_with_jp2h(rgb, lambda s: [
            (k, struct.pack(">I", 30) + b[4:] if k == b"ihdr" else b)
            for k, b in s]), "none"),
    }


_BOX_CASES = _box_cases()


@pytest.mark.parametrize("case", sorted(_BOX_CASES))
def test_jp2_boxes_decode_as_cv2(case):
    """Palettes, channel definitions and colour spaces built by hand: cv2's
    pixels (its YUV -> BGR for sYCC), or None where it refuses."""
    blob, verdict = _BOX_CASES[case]
    assert assert_answers_as_cv2(blob) == verdict


# ----------------------------------------------------- truncation, mutants
def _tiled(no_jp2):
    return _encode(_image("RGB", 37, 45, seed=9), tile_size=(16, 16),
                   no_jp2=no_jp2, irreversible=no_jp2)


@pytest.mark.parametrize("form", ["jp2", "j2k-tiles"])
def test_truncated_files_answer_as_cv2(form):
    """Every cut of a file (at every 5th byte and the last three): None,
    but where OpenJPEG decodes what it read (a stream cut right after an
    SOT marker's code: the tiles not read are 0)."""
    blob = _tiled(form != "jp2")
    cuts = list(range(1, len(blob), 5)) + [len(blob) - 3, len(blob) - 2,
                                           len(blob) - 1]
    verdicts = [assert_answers_as_cv2(blob[:k]) for k in cuts]
    assert verdicts.count("none") >= len(cuts) - 1
    sots = [i for i in range(len(blob) - 3)
            if blob[i:i + 4] == b"\xff\x90\x00\x0a"]
    assert len(sots) > 2 and all(
        assert_answers_as_cv2(blob[:i + 2]) == "decoded" for i in sots[1:])


def test_stream_end_rules_as_openjpeg():
    """After the last tile, the two bytes in EOC's place may be anything
    when nothing follows; a COM segment or more bytes there give None; a
    stray tile-part after every tile is decoded is not read."""
    blob = _encode(_image("RGB", 19, 27, seed=4), tile_size=(8, 8),
                   no_jp2=True)
    body = blob[:-2]
    stray = b"\xff\x90\x00\x0a" + struct.pack(">HIBB", 999, 14, 0, 1) + \
        b"\xff\x93\xff\xd9"
    cases = {body + b"\x00\x00": "decoded", body + b"\xff\xff": "decoded",
             body + b"\xff\x64\x00\x04ab\xff\xd9": "none",
             body + b"\x01\x02\x03\x04\x05": "none", body + stray: "decoded",
             blob + b"\xff\xd9": "decoded", body + b"\xff\x90\x00": "decoded"}
    for b, verdict in cases.items():
        assert assert_answers_as_cv2(b) == verdict


def _marker_cases():
    """A bare codestream (with PLT) and marker segments put into its main
    or tile-part header (Psot grown to match), as OpenJPEG reads them."""
    blob = _encode(_image("RGB", 24, 32, seed=4), no_jp2=True, plt=True)

    def seg(m, body):
        return struct.pack(">HH", m, len(body) + 2) + body

    def at(marker):
        return blob.find(marker)

    def body_of(marker):
        i = at(marker)
        return blob[i:i + 2 + int.from_bytes(blob[i + 2:i + 4], "big")]

    sot, sod = at(b"\xff\x90"), at(b"\xff\x93")

    def main(data, before=b"\xff\x52"):
        i = at(before)
        return blob[:i] + data + blob[i:]

    def tile(data):
        psot = int.from_bytes(blob[sot + 6:sot + 10], "big") + len(data)
        b = blob[:sod] + data + blob[sod:]
        return b[:sot + 6] + psot.to_bytes(4, "big") + b[sot + 10:]

    cod, qcd = body_of(b"\xff\x52"), body_of(b"\xff\x5c")
    return {
        "unknown-main-skipped": (main(seg(0xFF6C, b"abcd")), "decoded"),
        "unknown-main-odd": (main(seg(0xFF6C, b"abc")), "none"),
        "unknown-tile": (tile(seg(0xFF6C, b"abcd")), "none"),
        "com-tile": (tile(seg(0xFF64, b"\x00\x01hi")), "decoded"),
        "cod-twice-main": (main(cod, b"\xff\x5c"), "decoded"),
        "cod-twice-tile": (tile(cod + cod), "decoded"),
        "qcd-tile": (tile(qcd), "decoded"),
        "plt-main": (main(seg(0xFF58, b"\x00\x05")), "none"),
        "plt-dangling": (tile(seg(0xFF58, b"\x01\x85")), "none"),
        "tlm-st3": (main(seg(0xFF55, b"\x00\x30")), "decoded"),
        "tlm-short": (main(seg(0xFF55, b"\x00")), "none"),
        "plm-empty": (main(seg(0xFF57, b"")), "none"),
        "crg-wrong-size": (main(seg(0xFF63, b"\x00\x00")), "none"),
        "sop-main": (main(seg(0xFF91, b"\x00\x00")), "none"),
        "ppt-short": (tile(seg(0xFF61, b"\x00")), "none"),
        "cap-main": (main(seg(0xFF50, b"\x00\x00\x00\x00")), "decoded"),
    }


_MARKER_CASES = _marker_cases()


@pytest.mark.parametrize("case", sorted(_MARKER_CASES))
def test_marker_rules_as_openjpeg(case):
    """OpenJPEG's marker table: an unknown main-header segment is skipped
    two bytes at a time to the next known marker, an unknown one in a
    tile-part header fails, each marker only where it may stand, COD and
    QCD again override, PLT, TLM, PLM, CRG and PPT checked as it checks
    them."""
    blob, verdict = _MARKER_CASES[case]
    assert assert_answers_as_cv2(blob) == verdict


def _mutants(seed, n):
    rng = np.random.default_rng(seed)
    seeds = [_encode(_image("RGB", 40, 56, seed=seed), **kw) for kw in (
        {}, dict(irreversible=True, no_jp2=True, tile_size=(24, 24),
                 precinct_size=(16, 16)),
        dict(progression="RPCL", **_LAYERS))]
    out = []
    for blob in seeds:
        for _ in range(n):
            b = bytearray(blob)
            for _ in range(int(rng.integers(1, 4))):
                i = int(rng.integers(0, len(b)))
                if rng.random() < 0.5:
                    b[i] = int(rng.integers(0, 256))
                else:
                    b[i] ^= 1 << int(rng.integers(0, 8))
            out.append(bytes(b))
    return out


def test_mutants_answer_as_cv2():
    """120 seeded mutants (1-3 bytes overwritten or bits flipped, in the
    boxes, the headers and the packets) of three files: cv2's verdict and
    pixels each (OpenJPEG's lenient spots included: a packet header's
    zero-bit-plane count past the band's, a short jp2c box, a tile size
    that drops tile-parts)."""
    verdicts = [assert_answers_as_cv2(b) for b in _mutants(3, 40)]
    assert verdicts.count("decoded") > 60 and verdicts.count("none") > 5


_DECODE_MUTANTS = """
import ctypes, pickle, sys
import numpy as np
from onnxocr_tpu_torch.utils import imcodec
loaded = ctypes.CDLL(sys.argv[1])
for name, (restype, argtypes) in imcodec._JP2_SIGNATURES.items():
    getattr(loaded, name).restype = restype
    getattr(loaded, name).argtypes = argtypes
imcodec._JP2_LIB = loaded
counts = {"decoded": 0, "none": 0, "raised": 0}
with open(sys.argv[2], "rb") as f:
    mutants = pickle.load(f)
for blob in mutants:
    try:
        img = imcodec.imdecode(blob)
    except ValueError:
        counts["raised"] += 1
        continue
    if img is None:
        counts["none"] += 1
    else:
        assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
        counts["decoded"] += 1
print(counts)
"""


def test_mutants_never_crash(tmp_path):
    """Seeded mutants decode to an image, None or a ValueError in a process
    whose JPEG 2000 library is built with AddressSanitizer: no read or
    write outside a buffer."""
    import pickle
    import subprocess
    import sys
    repo = Path(__file__).resolve().parents[1]
    mutants = _mutants(17, 100)
    with open(tmp_path / "mutants.pkl", "wb") as f:
        pickle.dump(mutants, f)
    env = dict(os.environ, PYTHONPATH=str(repo))
    flags = ["-std=c++17", "-shared", "-fPIC", "-O1", "-g"]
    asan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    if os.path.isabs(asan) and os.path.exists(asan):
        flags += ["-fsanitize=address", "-fno-omit-frame-pointer"]
        # libstdc++ after libasan: the decoder's C++ exceptions go through
        # AddressSanitizer's __cxa_throw interceptor, which needs it loaded
        cxx = subprocess.run(["g++", "-print-file-name=libstdc++.so"],
                             capture_output=True, text=True).stdout.strip()
        env.update(LD_PRELOAD=f"{asan} {os.path.realpath(cxx)}",
                   ASAN_OPTIONS="detect_leaks=0")
    lib = tmp_path / "libjp2.so"
    subprocess.run(["g++", *flags, "-o", str(lib), str(imcodec.JP2_SOURCE)],
                   check=True, timeout=300)
    proc = subprocess.run(
        [sys.executable, "-c", _DECODE_MUTANTS, str(lib),
         str(tmp_path / "mutants.pkl")], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    counts = eval(proc.stdout.strip().splitlines()[-1])
    assert sum(counts.values()) == len(mutants)
    assert counts["decoded"] and counts["none"], counts


# ------------------------------------------------------------ size, memory
def _with_size(blob, w, h):
    """A bare codestream with SIZ's image and tile sizes replaced."""
    i = blob.find(b"\xff\x51")
    return blob[:i + 6] + struct.pack(">II", w, h) + blob[i + 14:i + 22] + \
        struct.pack(">II", w, h) + blob[i + 30:]


def test_hostile_sizes_answer_as_cv2():
    """An 8 x 8 codestream whose SIZ claims a tile of 2^20 x 8 decodes as
    cv2 decodes it; a side past 2^20 or more than 2^30 pixels raise, as
    cv2's validateInputImageSize does; 2^20 x 2^20 tiles of 8 px are more
    tiles than the standard allows: None."""
    blob = _encode(Image.fromarray(np.zeros((8, 8, 3), np.uint8)),
                   no_jp2=True)
    assert assert_answers_as_cv2(_with_size(blob, 1 << 20, 8)) == "decoded"
    for w, h in (((1 << 20) + 1, 8), (40000, 40000)):
        assert assert_answers_as_cv2(_with_size(blob, w, h)) == "raised"
    i = blob.find(b"\xff\x51")
    many = blob[:i + 6] + struct.pack(">II", 1 << 20, 1 << 20) + blob[i + 14:]
    assert assert_answers_as_cv2(many) == "none"


_PEAK_RSS = """
import resource, sys
import numpy as np
from onnxocr_tpu_torch.utils import imcodec
blob = open(sys.argv[1], "rb").read()
imcodec.jp2_lib()
before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
img = imcodec.imdecode(blob)
after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(img.shape, (after - before) * 1024, img.nbytes)
"""


def test_tiled_file_decodes_within_output_plus_48mb(tmp_path):
    """A 2048 x 2048 RGB file in tiles of 256 decodes (in a subprocess)
    with the peak RSS raised by less than the output plus 48 MB: a decoder
    that holds the whole image's coefficients needs 48 MB more (three
    int32 planes). The pixels equal cv2's."""
    import subprocess
    import sys
    rng = np.random.default_rng(2048)
    small = cv2.GaussianBlur(rng.integers(0, 256, (256, 256, 3)).astype(
        np.uint8), (5, 5), 0)
    big = cv2.resize(small, (2048, 2048), interpolation=cv2.INTER_LINEAR)
    blob = _encode(Image.fromarray(big), tile_size=(256, 256),
                   irreversible=True, quality_mode="dB", quality_layers=[38])
    path = tmp_path / "big.j2k"
    path.write_bytes(blob)
    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-c", _PEAK_RSS, str(path)],
        env=dict(os.environ, PYTHONPATH=str(repo)), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rise, nbytes = map(int, proc.stdout.split()[-2:])
    assert rise < nbytes + (48 << 20), (rise, nbytes)
    np.testing.assert_array_equal(imcodec.imdecode(blob), _cv2(blob))


# ----------------------------------------------------------------- samples
@pytest.mark.parametrize("name", ["sample_rev.jp2", "sample_irr_tiles.j2k",
                                  "sample_page_irr.jp2"])
def test_committed_samples_decode_as_cv2(name):
    """The JPEG 2000 samples the chip smoke decodes (a reversible JP2, an
    irreversible tiled codestream with precincts, and PIL's irreversible
    JP2 at rate 20 of the corpus page onnxocr_tpu/test_images/big_doc.jpg,
    1280 x 960, the JPEG's size): cv2's pixels here, and the shape and
    sha256 recorded in codec_samples.json."""
    import hashlib
    import json
    blob = (_SAMPLES / name).read_bytes()
    assert assert_answers_as_cv2(blob) == "decoded"
    want = json.loads((_SAMPLES / "codec_samples.json").read_text())[name]
    got = imcodec.imdecode(blob)
    assert list(got.shape) == want["shape"] and len(blob) == want["bytes"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
