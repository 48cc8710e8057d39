"""Arithmetic-coded JPEG (SOF9 sequential, SOF10 progressive, DAC
conditioning) in the port's image codec (onnxocr_tpu_torch/utils/imcodec.py,
C++ in csrc/host/imcodec.cc) against cv2 5.0, which reads it through
libjpeg-turbo's jdarith.c, on the CPU.

The files are written here by a small encoder compiled with gcc against
the system's libjpeg (`arith_code = TRUE`): grey, RGB (YCbCr) and CMYK /
YCCK (Adobe) components, sampling 4:4:4, 4:2:2, 4:2:0 and 1x2, restart
intervals, custom DAC conditioning (`arith_dc_L/U`, `arith_ac_K`),
sequential and progressive with successive approximation, odd sizes.
`imdecode` equals `cv2.imdecode(buf, cv2.IMREAD_COLOR)` value for value on
each, gives None where cv2 does on every cut of one file, and answers as
cv2 does on 100 seeded mutants, those whose garbage coefficients overflow
libjpeg-turbo's SIMD inverse DCT included (and so do Huffman mutants,
through the same inverse DCT); mutants decode without a fault under
AddressSanitizer. `jpeg_pil_rgb` equals PIL's `convert('RGB')` on the
same files.
"""
import io
import os
import shutil
import subprocess

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from onnxocr_tpu_torch.utils import imcodec

torch.set_num_threads(2)

_ENC = r"""
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>
/* enc in.raw w h comps out.jpg quality progressive restart hv dcL dcU acK ycck */
int main(int argc, char** argv) {
  if (argc < 14) return 2;
  int w = atoi(argv[2]), h = atoi(argv[3]), nc = atoi(argv[4]);
  FILE* f = fopen(argv[1], "rb");
  unsigned char* px = malloc((size_t)w * h * nc);
  if (fread(px, 1, (size_t)w * h * nc, f) != (size_t)w * h * nc) return 3;
  fclose(f);
  struct jpeg_compress_struct c; struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e); jpeg_create_compress(&c);
  FILE* o = fopen(argv[5], "wb"); jpeg_stdio_dest(&c, o);
  c.image_width = w; c.image_height = h; c.input_components = nc;
  c.in_color_space = nc == 1 ? JCS_GRAYSCALE : nc == 3 ? JCS_RGB : JCS_CMYK;
  jpeg_set_defaults(&c);
  if (nc == 4 && atoi(argv[13])) jpeg_set_colorspace(&c, JCS_YCCK);
  jpeg_set_quality(&c, atoi(argv[6]), TRUE);
  c.arith_code = TRUE;
  c.restart_interval = atoi(argv[8]);
  int hv = atoi(argv[9]);
  if (nc >= 3) { c.comp_info[0].h_samp_factor = hv / 10;
                 c.comp_info[0].v_samp_factor = hv % 10; }
  for (int i = 0; i < 16; i++) { c.arith_dc_L[i] = atoi(argv[10]);
    c.arith_dc_U[i] = atoi(argv[11]); c.arith_ac_K[i] = atoi(argv[12]); }
  if (atoi(argv[7])) jpeg_simple_progression(&c);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW r = px + (size_t)c.next_scanline * w * nc;
    jpeg_write_scanlines(&c, &r, 1); }
  jpeg_finish_compress(&c); fclose(o); jpeg_destroy_compress(&c);
  return 0;
}
"""

@pytest.fixture(scope="module")
def tools(tmp_path_factory):
    if shutil.which("gcc") is None or not os.path.exists(
            "/usr/include/jpeglib.h"):
        pytest.skip("needs gcc and libjpeg's headers to write the files")
    d = tmp_path_factory.mktemp("arith")
    (d / "enc.c").write_text(_ENC)
    subprocess.run(["gcc", "-O2", str(d / "enc.c"), "-o", str(d / "enc"),
                    "-ljpeg"], check=True)
    return d


def _encode(tools, img, q=75, prog=0, rst=0, hv=22, dc_l=0, dc_u=1, ac_k=5,
            ycck=0):
    h, w = img.shape[:2]
    nc = 1 if img.ndim == 2 else img.shape[2]
    np.ascontiguousarray(img).tofile(tools / "in.raw")
    subprocess.run([str(tools / "enc"), str(tools / "in.raw"), str(w),
                    str(h), str(nc), str(tools / "out.jpg"), str(q),
                    str(prog), str(rst), str(hv), str(dc_l), str(dc_u),
                    str(ac_k), str(int(ycck))], check=True)
    return (tools / "out.jpg").read_bytes()


def _cv2(blob):
    return cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.shape == b.shape and bool((a == b).all())


def _page(rng, h, w, nc):
    """Gradients, edges and noise: every coefficient band is busy."""
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([(xx * (3 + c) + yy * (5 + 2 * c)) % 256
                     for c in range(nc)], -1).astype(np.float64)
    base[(xx // 7 + yy // 5) % 3 == 0] = 30
    img = np.clip(base + rng.normal(0, 25, base.shape), 0, 255)
    img = img.astype(np.uint8)
    return img[..., 0] if nc == 1 else img


# (h, w, components, sampling hv of component 0, progressive, restart,
#  dc_L, dc_U, ac_K, YCCK, quality)
_CASES = [
    (33, 47, 1, 11, 0, 0, 0, 1, 5, 0, 75),
    (33, 47, 1, 11, 1, 0, 0, 1, 5, 0, 90),
    (40, 56, 3, 11, 0, 0, 0, 1, 5, 0, 75),    # 4:4:4
    (41, 57, 3, 21, 0, 0, 0, 1, 5, 0, 60),    # 4:2:2
    (37, 53, 3, 22, 0, 0, 0, 1, 5, 0, 75),    # 4:2:0
    (37, 53, 3, 12, 1, 0, 0, 1, 5, 0, 80),    # 1x2
    (37, 53, 3, 22, 1, 0, 0, 1, 5, 0, 75),
    (64, 48, 3, 11, 1, 0, 0, 1, 5, 0, 95),
    (37, 53, 3, 22, 0, 1, 0, 1, 5, 0, 75),    # restart every MCU
    (37, 53, 3, 22, 1, 3, 0, 1, 5, 0, 75),
    (37, 53, 3, 22, 0, 2, 2, 4, 12, 0, 50),   # DAC conditioning
    (37, 53, 3, 21, 1, 0, 1, 5, 1, 0, 85),
    (29, 31, 1, 11, 0, 0, 3, 6, 40, 0, 70),
    (26, 35, 4, 11, 0, 0, 0, 1, 5, 0, 75),    # CMYK (Adobe, inverted)
    (26, 35, 4, 22, 1, 2, 0, 1, 5, 1, 75),    # YCCK
    (26, 35, 4, 21, 0, 0, 1, 3, 20, 1, 85),
    (1, 1, 3, 22, 0, 0, 0, 1, 5, 0, 75),
    (1, 17, 3, 22, 1, 0, 0, 1, 5, 0, 75),
    (19, 1, 1, 11, 1, 0, 0, 1, 5, 0, 75),
    (9, 130, 3, 22, 0, 4, 0, 1, 5, 0, 30),
]


@pytest.mark.parametrize("case", range(len(_CASES)))
def test_arith_files_decode_as_cv2(tools, case):
    """Each file: SOF9 or SOF10 and a DAC segment, decoded value for value
    as cv2 decodes it, and read as PIL reads it by `jpeg_pil_rgb`."""
    h, w, nc, hv, prog, rst, dc_l, dc_u, ac_k, ycck, q = _CASES[case]
    rng = np.random.default_rng(case)
    blob = _encode(tools, _page(rng, h, w, nc), q, prog, rst, hv, dc_l,
                   dc_u, ac_k, ycck)
    assert (b"\xff\xca" if prog else b"\xff\xc9") in blob
    assert b"\xff\xcc" in blob
    want = _cv2(blob)
    assert want is not None
    got = imcodec.imdecode(blob)
    assert got is not None and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    pil = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
    np.testing.assert_array_equal(imcodec.jpeg_pil_rgb(blob), pil)


@pytest.mark.parametrize("prog", [0, 1])
def test_arith_every_cut_answers_as_cv2(tools, prog):
    """Every prefix of a 4:2:0 file with restarts gives cv2's answer:
    None where the decoder would read past the end, the image where a
    sequential file's rows are all out before its EOI."""
    blob = _encode(tools, _page(np.random.default_rng(7), 21, 35, 3),
                   prog=prog, rst=2)
    answers = {"none": 0, "image": 0}
    for cut in range(2, len(blob) + 1):
        part = blob[:cut]
        want, got = _cv2(part), imcodec.imdecode(part)
        assert _same(got, want), cut
        answers["none" if want is None else "image"] += 1
    print(answers)
    assert answers["image"] >= 1


def test_arith_mutants_answer_as_cv2(tools):
    """100 seeded mutants (1-3 bytes overwritten) of a sequential and a
    progressive file, with and without restarts: cv2's verdict and its
    pixels, those of the mutants whose garbage coefficients overflow the
    16-bit lanes of libjpeg-turbo's SIMD inverse DCT included."""
    img = _page(np.random.default_rng(11), 37, 53, 3)
    counts = {"decoded": 0, "none": 0}
    for prog, rst in ((0, 0), (0, 2), (1, 0), (1, 2)):
        blob = _encode(tools, img, prog=prog, rst=rst)
        rng = np.random.default_rng(100 + 10 * prog + rst)
        for _ in range(25):
            b = bytearray(blob)
            for _ in range(int(rng.integers(1, 4))):
                b[int(rng.integers(2, len(b)))] = int(rng.integers(256))
            want, got = _cv2(bytes(b)), imcodec.imdecode(bytes(b))
            assert _same(got, want)
            counts["none" if want is None else "decoded"] += 1
    print(counts)
    assert counts["decoded"] >= 60


def test_huffman_mutants_idct_as_cv2():
    """The inverse DCT is shared with the Huffman reader: 150 mutants of a
    baseline file's entropy bytes give cv2's verdict and decode to cv2's
    pixels, garbage coefficients wrapped and saturated as the SIMD IDCT
    does (C's islow range-limits them instead)."""
    rng = np.random.default_rng(9)
    img = np.clip(rng.normal(128, 60, (64, 80, 3)), 0, 255).astype(np.uint8)
    out = io.BytesIO()
    Image.fromarray(img).save(out, "JPEG", quality=90)
    blob = out.getvalue()
    both = 0
    for _ in range(150):
        b = bytearray(blob)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(600, len(b) - 2))] = int(rng.integers(256))
        want, got = _cv2(bytes(b)), imcodec.imdecode(bytes(b))
        assert _same(got, want)
        both += want is not None
    assert both >= 100


# ---- progressive files with scans missing or cut short: libjpeg-turbo's
# block smoothing (jdcoefct.c's decompress_smooth_data), its restart
# resynchronisation and its table rules, on Huffman and arithmetic files

def _segments(blob):
    """A JPEG's marker segments after SOI up to EOI as (marker, bytes), a
    scan with its entropy data (restart markers included) as one."""
    segs, i = [], 2
    while blob[i + 1] != 0xD9:
        m = blob[i + 1]
        j = i + 2 + ((blob[i + 2] << 8) | blob[i + 3])
        if m == 0xDA:
            while not (blob[j] == 0xFF and blob[j + 1] != 0 and
                       not 0xD0 <= blob[j + 1] <= 0xD7):
                j += 1
        segs.append((m, blob[i:j]))
        i = j
    return segs


def _join(segs):
    return b"\xff\xd8" + b"".join(s for _, s in segs) + b"\xff\xd9"


def _cut(scan, frac):
    """A scan whose data stops at `frac` of its length at an empty APP5:
    libjpeg hits the marker, the scan's other MCUs get no data."""
    at = ((scan[2] << 8) | scan[3]) + 2
    at += int((len(scan) - at) * frac)
    while scan[at - 1] == 0xFF:
        at += 1
    return scan[:at] + b"\xff\xe5\x00\x02" + scan[at:]


def _progressive(kind, tools=None):
    """A progressive file: PIL's scan script at 4:2:0, 4:4:4 and grey,
    cv2's with a restart every two MCUs, or the arithmetic encoder's."""
    rng = np.random.default_rng(5)
    h, w = (37, 53) if kind != "grey" else (45, 29)
    img = np.clip(rng.normal(128, 50, (h, w, 3)).cumsum(1) /
                  np.arange(1, w + 1)[None, :, None] +
                  rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
    if kind == "cv2-restarts":
        return cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                          cv2.IMWRITE_JPEG_RST_INTERVAL,
                                          2])[1].tobytes()
    if kind == "arith":
        return _encode(tools, img, prog=1, rst=2)
    out = io.BytesIO()
    if kind == "grey":
        Image.fromarray(img[:, :, 0]).save(out, "JPEG", quality=85,
                                           progressive=True)
    else:
        Image.fromarray(img).save(out, "JPEG", quality=85, progressive=True,
                                  subsampling=2 if kind == "420" else 0)
    return out.getvalue()


@pytest.mark.parametrize("kind",
                         ["420", "444", "grey", "cv2-restarts", "arith"])
def test_progressive_scans_missing_or_cut_decode_as_cv2(tools, kind):
    """Each scan dropped, every prefix of the scans, and the last scan of
    each prefix cut at 10 % and 50 % of its data: the coefficients that
    are still zero and incomplete are estimated from the 5 x 5 DC values
    around each block (the DC too where a component had no AC scan), with
    the progression status of the last complete rows, as cv2 does."""
    segs = _segments(_progressive(kind, tools))
    scans = [k for k, (m, _) in enumerate(segs) if m == 0xDA]
    assert len(scans) >= 5
    files = [_join([s for k, s in enumerate(segs) if k != drop])
             for drop in scans[1:]]
    for upto in range(1, len(scans) + 1):
        keep = [s for k, s in enumerate(segs) if k not in scans[upto:]]
        files.append(_join(keep))
        last = keep.index(segs[scans[upto - 1]])
        for frac in (0.1, 0.5):
            cut = list(keep)
            cut[last] = (0xDA, _cut(keep[last][1], frac))
            files.append(_join(cut))
    decoded = 0
    for blob in files:
        want, got = _cv2(blob), imcodec.imdecode(blob)
        assert _same(got, want)
        decoded += want is not None
    assert decoded == len(files)


@pytest.mark.parametrize("kind", ["420", "444", "grey", "cv2-restarts"])
def test_huffman_progressive_mutants_answer_as_cv2(kind):
    """60 seeded mutants (bytes overwritten, inserted or cut) of each
    progressive Huffman file: cv2's verdict and its pixels, markers
    destroyed included (a scan lost, a restart marker gone, a table that
    is no longer defined)."""
    blob = _progressive(kind)
    rng = np.random.default_rng(len(blob))
    decoded = 0
    for _ in range(60):
        b = bytearray(blob)
        for _ in range(int(rng.integers(1, 4))):
            r, i = rng.random(), int(rng.integers(2, len(b) - 2))
            if r < 0.7:
                b[i] = int(rng.integers(256))
            elif r < 0.85:
                b[i:i] = rng.bytes(int(rng.integers(1, 5)))
            else:
                del b[i:i + int(rng.integers(1, 9))]
        want, got = _cv2(bytes(b)), imcodec.imdecode(bytes(b))
        assert _same(got, want)
        decoded += want is not None
    assert decoded >= 30


def _header_case(name):
    """(file, whether cv2 decodes it) for one of libjpeg's marker rules."""
    prog = _progressive("420")
    segs = _segments(prog)
    scans = [k for k, (m, _) in enumerate(segs) if m == 0xDA]
    if name == "app0-length-1":  # skipped from after its length bytes
        return prog[:2] + b"\xff\xe0\x00\x01junk" + prog[2:], True
    if name == "dc-refine-table-byte":  # a DC refinement reads no table
        k = next(k for k in scans if segs[k][1][4] == 3 and
                 segs[k][1][13] >> 4)
        scan = bytearray(segs[k][1])
        scan[8] = 0xC9
        return _join(segs[:k] + [(0xDA, bytes(scan))] + segs[k + 1:]), True
    if name == "progressive-table-missing":  # no standard tables here
        k = next(k for k, (m, _) in enumerate(segs) if m == 0xC4)
        return _join(segs[:k] + segs[k + 1:]), False
    if name == "restart-marker-gone":  # the next segment decodes zeros
        blob = _progressive("cv2-restarts")
        k = blob.index(b"\xff\xd3", blob.index(b"\xff\xda"))
        return blob[:k] + blob[k + 2:], True
    base = cv2.imencode(".jpg", np.full((24, 40, 3), 90, np.uint8))[1]
    base = base.tobytes()
    if name == "baseline-then-long-app5":  # the rows are out already
        return base[:-2] + b"\xff\xf5\xff\xf0" + bytes(16), True
    if name == "huge-frame-bad-length":  # refused before the size check
        k = base.index(b"\xff\xc0")
        return base[:k + 5] + b"\xc6\x00\x82\x1c\x01" + base[k + 10:], \
            False
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "app0-length-1", "dc-refine-table-byte", "progressive-table-missing",
    "restart-marker-gone", "baseline-then-long-app5",
    "huge-frame-bad-length"])
def test_marker_rules_answer_as_cv2(name):
    """libjpeg's rules that the mutants above found: each file gets cv2's
    verdict, and its pixels where cv2 decodes it."""
    blob, decodes = _header_case(name)
    want, got = _cv2(blob), imcodec.imdecode(blob)
    assert (want is not None) == decodes
    assert _same(got, want)


def test_arith_samples_match_record():
    """The committed samples: the corpus page big_doc written by the
    encoder above as SOF9 and as SOF10, decoded as cv2 decodes them."""
    from pathlib import Path
    samples = Path(imcodec.__file__).resolve().parents[1] / "assets" / \
        "samples"
    for name, marker in (("sample_arith.jpg", b"\xff\xc9"),
                         ("sample_arith_prog.jpg", b"\xff\xca")):
        blob = (samples / name).read_bytes()
        assert marker in blob
        np.testing.assert_array_equal(imcodec.imdecode(blob), _cv2(blob))


def _arith_mutant(blob, rng):
    """Bytes of the header segments (SOF9/10, DAC, DQT, DRI, SOS) or of
    the whole file overwritten, inserted or cut."""
    b = bytearray(blob)
    heads = [i for i in range(len(b) - 1) if b[i] == 0xFF and
             b[i + 1] in (0xC9, 0xCA, 0xCC, 0xDB, 0xDD, 0xDA)]
    for _ in range(int(rng.integers(1, 4))):
        r = rng.random()
        if r < 0.5 and heads:
            i = min(len(b) - 1, int(rng.choice(heads)) + 2 +
                    int(rng.integers(0, 14)))
            b[i] = int(rng.choice([0, 1, 0x0F, 0x10, 0x3F, 0xFF,
                                   rng.integers(256)]))
        else:
            i = int(rng.integers(2, len(b)))
            if r < 0.7:
                b[i] = int(rng.integers(256))
            elif r < 0.85:
                b[i:i] = rng.bytes(int(rng.integers(1, 8)))
            else:
                del b[i:i + int(rng.integers(1, 16))]
    return bytes(b)


def test_arith_mutants_never_fault(tools, tmp_path):
    """Seeded mutants of arithmetic-coded files (marker segments, DAC
    included, and entropy bytes overwritten, inserted or cut) decode to an
    image, None or a ValueError in a build of the codec with
    AddressSanitizer where the compiler has it: nothing is read or written
    out of bounds."""
    import pickle
    import sys
    from test_torch_imcodec import _DECODE_MUTANTS
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    seeds = []
    for case in (2, 6, 9, 10, 14):
        h, w, nc, hv, prog, rst, dc_l, dc_u, ac_k, ycck, q = _CASES[case]
        seeds.append(_encode(tools, _page(np.random.default_rng(case), h, w,
                                          nc), q, prog, rst, hv, dc_l, dc_u,
                             ac_k, ycck))
    rng = np.random.default_rng(1)
    mutants = [_arith_mutant(blob, rng) for blob in seeds for _ in range(40)]
    with open(tmp_path / "mutants.pkl", "wb") as f:
        pickle.dump(mutants, f)
    env = dict(os.environ, PYTHONPATH=str(repo))
    flags = ["-std=c++17", "-shared", "-fPIC", "-O0"]  # quick to build
    asan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    if os.path.isabs(asan) and os.path.exists(asan):
        flags += ["-fsanitize=address", "-fno-omit-frame-pointer"]
        env.update(LD_PRELOAD=asan, ASAN_OPTIONS="detect_leaks=0")
    lib = tmp_path / "libimcodec.so"
    subprocess.run(["g++", *flags, "-o", str(lib), str(imcodec.SOURCE)],
                   check=True, timeout=300)
    proc = subprocess.run(
        [sys.executable, "-c", _DECODE_MUTANTS, str(lib),
         str(tmp_path / "mutants.pkl")], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    counts = eval(proc.stdout.strip().splitlines()[-1])
    assert sum(counts.values()) == len(mutants)
    assert counts["decoded"] and counts["none"], counts
