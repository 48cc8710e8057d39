"""The port's TIFF reader (onnxocr_tpu_torch/utils/imcodec.py over
csrc/host/tiff.cc and csrc/host/imcodec.cc) against cv2 5.0 on the CPU, for
the layouts scanners, fax gateways and print workflows write.

Every case is value-equal to `cv2.imdecode(buf, cv2.IMREAD_COLOR)` (0
values differ), or None where cv2 gives None:

* CCITT bilevel files from PIL/libtiff: compression 2 (Modified Huffman
  RLE), 3 with T4Options 1D, 2D and EOL fill bits, 4 (Group 4);
  MinIsWhite and MinIsBlack; FillOrder 1 and 2; one strip or strips of a
  few rows with a short last strip; tiles built from PIL's tile-sized
  strips; seeded bit and byte mutants of each (libtiff's recovery from bad
  code words and premature EOLs, which cv2 still returns).
* JPEG-in-TIFF (compression 7) from PIL: YCbCr 2 x 2 (libtiff's
  JPEGCOLORMODE_RGB through libjpeg's conversion), other YCbCrSubsampling
  tags and none (the first strip's SOF decides), RGB and grey without
  conversion, CMYK; strips and tiles; FillOrder 2 (the JPEG codec takes its
  data unreversed); cut and mutated strips; grey and palette files whose
  BitsPerSample is not the frames' 8 (None, as libtiff refuses them).
* CMYK (InkSet 1, chunky and planar), YCbCr (uncompressed, every
  subsampling libtiff has a put routine for and two it has none for,
  planar, ReferenceBlackWhite and YCbCrCoefficients given and defaulted)
  and CIELab (8- and 16-bit, WhitePoint given and defaulted; planar gives
  None) from PIL and built by hand, with every compression already read.
* BigTIFF (magic 43, LONG8 offsets) in both byte orders, strips and tiles.
* FillOrder 2 under none, PackBits, LZW and Deflate (libtiff reverses the
  bits of the raw data first).
* Uncompressed tiles over a grid of tile sizes, sample layouts and depths:
  cv2 5.0 reads them only where a tile's bytes are a whole number of KiB.

A build of the libraries with AddressSanitizer decodes the mutants of every
kind without a fault.
"""
import io
import os
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from onnxocr_tpu_torch.ops import native
from onnxocr_tpu_torch.utils import imcodec

from test_torch_imcodec import _lzw, _packbits, write_tiff

REPO = Path(__file__).resolve().parents[1]
PAGE = REPO / "onnxocr_tpu" / "test_images"


def answers_as_cv2(blob):
    """cv2's verdict on the bytes ('decoded' or 'none'), held: the same
    pixels where it decodes, None where it does not."""
    want = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
    got = imcodec.imdecode(blob)
    if want is None:
        assert got is None
        return "none"
    assert got is not None and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return "decoded"


def pil_tiff(img, **kw):
    out = io.BytesIO()
    img.save(out, "TIFF", **kw)
    return out.getvalue()


def tiff_file(w, h, chunks, tags, order="<", big=False, tile=None,
              rps=None):
    """A one-IFD TIFF (or BigTIFF) of the given strips or tiles and tags
    ({tag: (type, values)}; type 7 takes bytes); offsets and byte counts
    are filled in."""
    head = 16 if big else 8
    offs, pos = [], head
    for c in chunks:
        offs.append(pos)
        pos += len(c)
    off_type = 16 if big else 4
    tags = dict(tags)
    tags.update({256: (4, [w]), 257: (4, [h])})
    if tile:
        tags.update({322: (4, [tile[0]]), 323: (4, [tile[1]]),
                     324: (off_type, offs),
                     325: (off_type, [len(c) for c in chunks])})
    else:
        tags.update({273: (off_type, offs), 278: (4, [rps or h]),
                     279: (off_type, [len(c) for c in chunks])})
    codes = {1: "B", 3: "H", 4: "I", 5: "II", 16: "Q"}
    entry, inline = (20, 8) if big else (12, 4)
    ifd_pos = pos
    blob_pos = ifd_pos + (8 if big else 2) + entry * len(tags) + \
        (8 if big else 4)
    ifd = struct.pack(order + ("Q" if big else "H"), len(tags))
    blob = bytearray()
    for tag in sorted(tags):
        typ, vals = tags[tag]
        if typ == 7:
            raw, n = bytes(vals), len(vals)
        elif typ == 5:
            raw = b"".join(struct.pack(order + "II", *v) for v in vals)
            n = len(vals)
        else:
            raw, n = struct.pack(order + codes[typ] * len(vals), *vals), \
                len(vals)
        count = struct.pack(order + ("HHQ" if big else "HHI"), tag, typ, n)
        if len(raw) <= inline:
            ifd += count + raw.ljust(inline, b"\0")
        else:
            ifd += count + struct.pack(order + ("Q" if big else "I"),
                                       blob_pos + len(blob))
            blob += raw + b"\0" * (len(raw) % 2)
    magic = (b"II" if order == "<" else b"MM")
    header = magic + (struct.pack(order + "HHHQ", 43, 8, 0, ifd_pos) if big
                      else struct.pack(order + "HI", 42, ifd_pos))
    return header + b"".join(chunks) + ifd + bytes(8 if big else 4) + \
        bytes(blob)


def ifd_tags(blob):
    """A one-IFD TIFF's tags as the decoder reads them, its strip or tile
    arrays read through the decoder's own deferred readers, each for the
    values its entry holds."""
    _, tags, entries, arrays = imcodec._tiff_ifd(blob)
    held = {}
    for tag, _, n in entries:
        held.setdefault(tag, n)
    return {**tags, **{tag: read(held[tag]) for tag, read in arrays.items()}}


def strips_of(blob):
    """The strip bytes and tags of a one-IFD TIFF."""
    tags = ifd_tags(blob)
    offs, counts = tags.get(273, tags.get(324)), tags.get(279, tags.get(325))
    return [blob[o:o + c] for o, c in zip(offs, counts)], tags


def bilevel_page():
    grey = cv2.imread(str(PAGE / "ticket.jpg"), cv2.IMREAD_GRAYSCALE)
    return grey[:300, :260] > 140


def seeded_bits(seed, h, w):
    rng = np.random.default_rng(seed)
    runs = rng.integers(1, 40, (h, w // 2 + 2)).cumsum(1)
    img = np.zeros((h, w), bool)
    for y in range(h):
        edges = runs[y][runs[y] < w]
        for a, b in zip(edges[::2], edges[1::2]):
            img[y, a:b] = True
    img[h // 3] = ~img[h // 3]          # a row of long runs
    return img


# ------------------------------------------------------------------ CCITT
FAX = {"rle": ("tiff_ccitt", {}), "g3-1d": ("group3", {}),
       "g3-2d": ("group3", {292: 1}), "g3-2d-fill": ("group3", {292: 5}),
       "g3-1d-fill": ("group3", {292: 4}), "g4": ("group4", {})}


def fax_files(kind, photo, fill):
    comp, info = FAX[kind]
    info = {**info, 262: photo}
    if fill == 2:
        info[266] = 2
    images = [seeded_bits(1, 37, 67), seeded_bits(2, 9, 3000),
              seeded_bits(3, 5, 1), bilevel_page()]
    for img in images:
        yield pil_tiff(Image.fromarray(img), compression=comp, tiffinfo=info)
    for rps in (1, 7):
        yield pil_tiff(Image.fromarray(images[0]), compression=comp,
                       tiffinfo={**info, 278: rps})


@pytest.mark.parametrize("fill", [1, 2])
@pytest.mark.parametrize("photo", [0, 1])
@pytest.mark.parametrize("kind", list(FAX))
def test_ccitt_from_libtiff_matches_cv2(kind, photo, fill):
    """PIL's libtiff encodings of seeded run patterns (runs past 2560, a
    3000-pixel row, a 1-pixel column) and of a corpus page, as one strip
    and as strips of 1 and 7 rows with a short last one."""
    for blob in fax_files(kind, photo, fill):
        assert answers_as_cv2(blob) == "decoded"


def _tile_strips(img, comp, info, tw, th):
    """A tiled file from PIL's single-strip encodings of each tile (the
    tiles padded white), with PIL's other tags."""
    h, w = img.shape[:2]
    chunks = []
    for ty in range(0, h, th):
        for tx in range(0, w, tw):
            t = np.zeros((th, tw) + img.shape[2:], img.dtype)
            part = img[ty:ty + th, tx:tx + tw]
            t[:part.shape[0], :part.shape[1]] = part
            strips, tags = strips_of(pil_tiff(
                Image.fromarray(t), compression=comp, tiffinfo=info))
            chunks.append(b"".join(strips))
    keep = {k: v for k, v in tags.items()
            if k in (258, 259, 262, 266, 277, 284, 292, 293, 530)}
    out = {}
    for k, v in keep.items():
        out[k] = (3, list(v)) if k != 292 else (4, list(v))
    if 347 in tags:
        out[347] = (7, tags[347])
    return tiff_file(w, h, chunks, out, tile=(tw, th))


@pytest.mark.parametrize("kind", ["rle", "g3-2d", "g4"])
def test_ccitt_tiles_match_cv2(kind):
    """Tiles of 32 x 16 and 64 x 48 whose data are PIL's strips of a
    tile-sized image."""
    comp, info = FAX[kind]
    img = seeded_bits(4, 70, 90)
    for tw, th in ((32, 16), (64, 48)):
        assert answers_as_cv2(_tile_strips(img, comp, {**info, 262: 0},
                                           tw, th)) == "decoded"


def _fax_mutants(blob, rng, n):
    strips, _ = strips_of(blob)
    tags = ifd_tags(blob)
    offs = tags[273]
    for _ in range(n):
        b = bytearray(blob)
        for _ in range(int(rng.integers(1, 4))):
            k = int(rng.integers(len(strips)))
            if not len(strips[k]):
                continue
            i = offs[k] + int(rng.integers(len(strips[k])))
            r = rng.random()
            if r < 0.5:
                b[i] ^= 1 << int(rng.integers(8))
            elif r < 0.8:
                b[i] = int(rng.choice([0, 0xFF, rng.integers(256)]))
            else:                     # a run of zero bytes: EOL-like codes
                b[i:i + 3] = bytes(len(b[i:i + 3]))
        yield bytes(b)


@pytest.mark.parametrize("kind", list(FAX))
def test_ccitt_mutants_answer_as_cv2(kind):
    """60 seeded mutants of each kind's strips (bits flipped, bytes
    overwritten, zero runs that read as EOLs): libtiff warns, fills the
    rest of the row white and goes on, and cv2 returns what it wrote; the
    port returns the same pixels."""
    comp, info = FAX[kind]
    rng = np.random.default_rng(len(kind))
    img = seeded_bits(5, 40, 150)
    seeds = [pil_tiff(Image.fromarray(img), compression=comp,
                      tiffinfo={**info, 278: 9})]
    seeds.append(pil_tiff(Image.fromarray(img), compression=comp,
                          tiffinfo={**info, 266: 2}))
    verdicts = []
    for blob in seeds:
        for mutant in _fax_mutants(blob, rng, 30):
            verdicts.append(answers_as_cv2(mutant))
    assert verdicts.count("decoded") >= len(verdicts) - 2


# ------------------------------------------------------------------- JPEG
def _small_rgb():
    return cv2.imread(str(PAGE / "card.jpg"))[:, :, ::-1][:97, :131].copy()


@pytest.mark.parametrize("case", ["ycbcr", "ycbcr-rps", "ycbcr-q95",
                                  "ycbcr-11", "ycbcr-21", "ycbcr-no-530",
                                  "rgb", "grey", "cmyk", "fill2"])
def test_jpeg_in_tiff_matches_cv2(case):
    """PIL's JPEG-compressed TIFFs (libtiff's abbreviated strips with the
    JPEGTables tag): YCbCr 2 x 2 by default, other subsampling tags, the
    tag dropped (libtiff reads the first strip's SOF), RGB and grey stored
    without conversion, CMYK, strips of 16 rows, FillOrder 2."""
    rgb = _small_rgb()
    im = Image.fromarray(rgb)
    kw = {"compression": "jpeg"}
    if case == "ycbcr-rps":
        kw["tiffinfo"] = {278: 16}
    elif case == "ycbcr-q95":
        kw["quality"] = 95
    elif case in ("ycbcr-11", "ycbcr-21"):
        kw["tiffinfo"] = {530: (1, 1) if case == "ycbcr-11" else (2, 1)}
    elif case == "rgb":
        kw["tiffinfo"] = {262: 2}
    elif case == "grey":
        im = im.convert("L")
    elif case == "cmyk":
        im = im.convert("CMYK")
    elif case == "fill2":
        kw["tiffinfo"] = {266: 2}
    blob = pil_tiff(im, **kw)
    if case == "ycbcr-no-530":
        strips, tags = strips_of(blob)
        blob = tiff_file(rgb.shape[1], rgb.shape[0], strips, {
            258: (3, [8, 8, 8]), 259: (3, [7]), 262: (3, [6]),
            277: (3, [3]), 347: (7, tags[347])}, rps=tags[278][0])
    assert answers_as_cv2(blob) == "decoded"


def test_jpeg_in_tiff_tiles_and_cv2_files_answer_as_cv2():
    """Tiles of 64 x 32 from PIL's tile-sized JPEG strips (YCbCr and
    grey), and cv2's own JPEG TIFFs (cv2 5.0 writes them with empty
    strips, which both give None for)."""
    rgb = _small_rgb()
    for img, info in ((rgb, {}), (rgb[:, :, 1].copy(), {})):
        assert answers_as_cv2(_tile_strips(img, "jpeg", info, 64, 32)) == \
            "decoded"
    bgr = rgb[:, :, ::-1].copy()
    for arr in (bgr, bgr[:, :, 0]):
        ok, buf = cv2.imencode(".tiff", arr, [
            cv2.IMWRITE_TIFF_COMPRESSION, cv2.IMWRITE_TIFF_COMPRESSION_JPEG])
        answers_as_cv2(bytes(buf))


def test_jpeg_in_tiff_cuts_and_mutants_answer_as_cv2():
    """A strip cut short decodes with libtiff's fake EOI (the rest of the
    strip from zero coefficients); a corrupt JPEGTables or frame header is
    refused; 60 seeded mutants of the strips and tables."""
    blob = pil_tiff(Image.fromarray(_small_rgb()), compression="jpeg",
                    tiffinfo={278: 32})
    strips, tags = strips_of(blob)
    rng = np.random.default_rng(7)
    verdicts = []
    for cut in (10, 200, len(strips[1]) // 2, len(strips[1]) - 3):
        b = bytearray(blob)
        t = ifd_tags(blob)
        e = blob.index(struct.pack("<HHI", 279, 4, len(strips)))
        cnt_off, = struct.unpack("<I", blob[e + 8:e + 12])
        b[cnt_off + 4:cnt_off + 8] = struct.pack("<I", cut)
        verdicts.append(answers_as_cv2(bytes(b)))
    assert "decoded" in verdicts
    for _ in range(60):
        b = bytearray(blob)
        for _ in range(int(rng.integers(1, 3))):
            i = int(rng.integers(8, len(b) - 200))
            b[i] = int(rng.integers(256)) if rng.random() < 0.5 else \
                b[i] ^ (1 << int(rng.integers(8)))
        verdicts.append(answers_as_cv2(bytes(b)))
    assert verdicts.count("decoded") > 30


def _grey_jpeg_as(photo, bps):
    """PIL's grey JPEG-in-TIFF of the small page (8-bit frames) relabelled
    as grey or palette at `bps` bits a sample."""
    rgb = _small_rgb()
    strips, tags = strips_of(pil_tiff(Image.fromarray(rgb).convert("L"),
                                      compression="jpeg"))
    info = {258: (3, [bps]), 259: (3, [7]), 262: (3, [photo]),
            277: (3, [1]), 347: (7, tags[347])}
    if photo == 3:
        n = 1 << min(bps, 8)
        info[320] = (3, [v % 256 * 257 for v in range(3 * n)])
    return tiff_file(rgb.shape[1], rgb.shape[0], strips, info,
                     rps=tags[278][0])


@pytest.mark.parametrize("bps", [1, 4, 8, 16])
@pytest.mark.parametrize("photo", [1, 3])
def test_jpeg_in_tiff_bits_per_sample_answer_as_cv2(photo, bps):
    """Grey and palette JPEG-in-TIFFs whose BitsPerSample is not the
    frame's 8 bits give None, as libtiff's "Improper JPEG data precision"
    makes cv2 give None; at 8 bits both decode."""
    assert answers_as_cv2(_grey_jpeg_as(photo, bps)) == \
        ("decoded" if bps == 8 else "none")


def test_jpeg_tiff_rows_stay_inside_the_strip_buffer():
    """ocr_jpeg_tiff copies no row past the caller's row stride: a frame
    wider than the stride fills each row's `bpl` bytes and leaves the bytes
    after the buffer as they were."""
    strips, tags = strips_of(_grey_jpeg_as(1, 8))
    src = np.frombuffer(strips[0], np.uint8).copy()
    tables = np.frombuffer(tags[347], np.uint8).copy()
    w, rows = tags[256][0], tags[278][0]
    bpl = (w + 7) // 8
    out = np.full(rows * bpl + 4096, 0xAB, np.uint8)
    p = imcodec._ptr
    assert imcodec.lib().ocr_jpeg_tiff(
        p(tables), tables.size, p(src), src.size, w, rows, 0, 1, 1, 1, 0,
        p(out), bpl, rows) == 1
    assert (out[rows * bpl:] == 0xAB).all()
    want = cv2.imdecode(np.frombuffer(_grey_jpeg_as(1, 8), np.uint8),
                        cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(out[:rows * bpl].reshape(rows, bpl),
                                  want[:, :bpl])


# ------------------------------------------------- CMYK, YCbCr, CIELab
@pytest.mark.parametrize("mode", ["CMYK", "YCbCr", "LAB"])
def test_colour_spaces_from_pil_match_cv2(mode):
    """PIL's CMYK, YCbCr and LAB TIFFs at every compression it writes
    (none, PackBits, LZW, Deflate, JPEG), strips of 8 rows too."""
    im = Image.fromarray(_small_rgb()).convert(mode)
    for comp in (None, "packbits", "tiff_lzw", "tiff_deflate", "jpeg"):
        for info in ({}, {278: 8}):
            kw = {"tiffinfo": info}
            if comp:
                kw["compression"] = comp
            answers_as_cv2(pil_tiff(im, **kw))


def _ycbcr_units(ycc, sh, sv):
    """Y, Cb, Cr planes → TIFF's subsampled data units (sh · sv luma
    samples, then Cb, Cr of the unit's top-left pixel), the edges padded
    by replication."""
    h, w = ycc.shape[:2]
    ph, pw = -(-h // sv) * sv, -(-w // sh) * sh
    pad = np.pad(ycc, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    units = []
    for by in range(0, ph, sv):
        for bx in range(0, pw, sh):
            blk = pad[by:by + sv, bx:bx + sh]
            units.append(np.concatenate([blk[:, :, 0].reshape(-1),
                                         blk[0, 0, 1:]]))
    return np.concatenate(units).astype(np.uint8)


@pytest.mark.parametrize("sub", [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1),
                                 (4, 2), (4, 4), (2, 4), (1, 4)])
def test_ycbcr_subsampling_matches_cv2(sub):
    """Uncompressed and LZW YCbCr of each subsampling at odd sizes, one
    strip and strips of a whole number of units; (2, 4) and (1, 4) have no
    put routine in libtiff and give None; ReferenceBlackWhite and
    YCbCrCoefficients given (the JPEG ranges, Rec. 709) and defaulted."""
    rng = np.random.default_rng(sub[0] * 8 + sub[1])
    h, w = 29, 43
    ycc = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    sh, sv = sub
    extra = [{}, {532: (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                            (240, 1)]),
                  529: (5, [(2126, 10000), (7152, 10000), (722, 10000)])}]
    verdicts = set()
    for tags in extra:
        for rps in (h, 4 * sv):
            chunks = []
            for y in range(0, h, rps):
                units = _ycbcr_units(ycc[y:y + rps], sh, sv).tobytes()
                chunks.append(units)
            base = {258: (3, [8, 8, 8]), 259: (3, [1]), 262: (3, [6]),
                    277: (3, [3]), 530: (3, [sh, sv])}
            base.update(tags)
            verdicts.add(answers_as_cv2(tiff_file(w, h, chunks, base,
                                                  rps=rps)))
            base[259] = (3, [5])
            verdicts.add(answers_as_cv2(tiff_file(
                w, h, [_lzw(c) for c in chunks], base, rps=rps)))
    assert verdicts == ({"none"} if sub in ((2, 4), (1, 4)) else
                        {"decoded"})


def test_planar_and_separated_layouts_answer_as_cv2():
    """Planar YCbCr 1 x 1 (putseparate8bitYCbCr11tile) and 2 x 2 (no put
    routine: None), CMYK chunky and planar by hand, InkSet 2 and 16-bit
    CMYK (None), CIELab 16-bit in both byte orders, a WhitePoint given,
    planar CIELab (None)."""
    rng = np.random.default_rng(3)
    h, w = 21, 34
    px = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    verdicts = {}
    for sub in ((1, 1), (2, 2)):
        verdicts[f"ycc-planar-{sub}"] = answers_as_cv2(write_tiff_tags(
            px[:, :, :3], 6, 8, planar=2, tags={530: (3, list(sub))}))
    for planar in (1, 2):
        for comp in (1, 5, 32773):
            verdicts[f"cmyk-{planar}-{comp}"] = answers_as_cv2(
                write_tiff_tags(px, 5, 8, planar=planar, comp=comp))
    verdicts["inkset-2"] = answers_as_cv2(write_tiff_tags(
        px, 5, 8, tags={332: (3, [2])}))
    verdicts["cmyk-16"] = answers_as_cv2(write_tiff_tags(
        px.astype(np.uint16) * 257, 5, 16))
    lab16 = rng.integers(0, 65536, (h, w, 3)).astype(np.uint16)
    for order in ("<", ">"):
        verdicts[f"lab16{order}"] = answers_as_cv2(write_tiff_tags(
            lab16, 8, 16, order=order))
    verdicts["lab-white"] = answers_as_cv2(write_tiff_tags(
        px[:, :, :3], 8, 8, tags={318: (5, [(3127, 10000), (3290, 10000)])}))
    verdicts["lab-planar"] = answers_as_cv2(write_tiff_tags(
        px[:, :, :3], 8, 8, planar=2))
    assert verdicts == {
        "ycc-planar-(1, 1)": "decoded", "ycc-planar-(2, 2)": "none",
        **{f"cmyk-{p}-{c}": "decoded" for p in (1, 2) for c in (1, 5, 32773)},
        "inkset-2": "none", "cmyk-16": "none", "lab16<": "decoded",
        "lab16>": "decoded", "lab-white": "decoded", "lab-planar": "none"}


def write_tiff_tags(samples, photo, bps, comp=1, planar=1, order="<",
                    tags=None):
    """`write_tiff`'s strips with extra tags appended to its IFD."""
    h, w, spp = samples.shape
    dt = np.dtype(order + "u2") if bps == 16 else np.uint8
    codec = {1: lambda r: r, 5: _lzw, 32773: _packbits,
             8: zlib.compress}[comp]
    planes = [samples] if planar == 1 else \
        [samples[:, :, i:i + 1] for i in range(spp)]
    chunks = [codec(p.astype(dt).tobytes()) for p in planes]
    base = {258: (3, [bps] * spp), 259: (3, [comp]), 262: (3, [photo]),
            277: (3, [spp]), 284: (3, [planar])}
    base.update(tags or {})
    return tiff_file(w, h, chunks, base, order=order)


# ---------------------------------------------------------------- BigTIFF
@pytest.mark.parametrize("order", ["<", ">"])
def test_bigtiff_matches_cv2(order):
    """BigTIFFs by hand (LONG8 offsets and counts, 20-byte entries) of
    strips and tiles, RGB LZW and G4; PIL's big_tiff files; imdecode
    routes magic 43 to the TIFF reader."""
    rng = np.random.default_rng(43)
    rgb = rng.integers(0, 256, (30, 50, 3)).astype(np.uint8)
    tags = {258: (3, [8, 8, 8]), 259: (3, [5]), 262: (3, [2]),
            277: (3, [3])}
    blobs = [tiff_file(50, 30, [_lzw(rgb[y:y + 8].tobytes())
                                for y in range(0, 30, 8)], tags,
                       order=order, big=True, rps=8)]
    tiles = []
    for ty in range(0, 30, 16):
        for tx in range(0, 50, 16):
            t = np.zeros((16, 16, 3), np.uint8)
            part = rgb[ty:ty + 16, tx:tx + 16]
            t[:part.shape[0], :part.shape[1]] = part
            tiles.append(_lzw(t.tobytes()))
    blobs.append(tiff_file(50, 30, tiles, tags, order=order, big=True,
                           tile=(16, 16)))
    strips, t = strips_of(pil_tiff(Image.fromarray(seeded_bits(6, 30, 50)),
                                   compression="group4"))
    blobs.append(tiff_file(50, 30, strips, {
        258: (3, [1]), 259: (3, [4]), 262: (3, [0]), 277: (3, [1])},
        order=order, big=True))
    if order == "<":
        blobs.append(pil_tiff(Image.fromarray(rgb), big_tiff=True))
    for blob in blobs:
        assert blob[2:4] in (b"+\0", b"\0+")
        assert answers_as_cv2(blob) == "decoded"


# ------------------------------------------------------------- FillOrder
@pytest.mark.parametrize("comp", [1, 32773, 5, 8])
def test_fill_order_2_matches_cv2(comp):
    """FillOrder 2 under none, PackBits, LZW and Deflate, 8-bit RGB and
    1-bit: libtiff reverses each raw byte's bits before decoding."""
    rng = np.random.default_rng(comp)
    rgb = rng.integers(0, 256, (19, 23, 3)).astype(np.uint8)
    bits = rng.integers(0, 2, (19, 23, 1)).astype(np.uint8)
    for samples, photo, bps in ((rgb, 2, 8), (bits, 0, 1)):
        blob = write_tiff(samples, photo, bps, comp=comp, rps=5)
        tags = ifd_tags(blob)
        b = bytearray(blob)
        for o, c in zip(tags[273], tags[279]):       # the data reversed
            b[o:o + c] = imcodec._BIT_REVERSE[np.frombuffer(
                blob, np.uint8, c, o)].tobytes()
        strips, t = strips_of(bytes(b))
        keep = {k: (3, list(v)) for k, v in t.items()
                if k in (258, 259, 262, 277)}
        keep[266] = (3, [2])
        assert answers_as_cv2(tiff_file(23, 19, strips, keep,
                                        rps=5)) == "decoded"


# ------------------------------------------------------- uncompressed tiles
@pytest.mark.parametrize("spp,bps", [(1, 8), (3, 8), (4, 8), (1, 16),
                                     (3, 16)])
def test_uncompressed_tiles_answer_as_cv2(spp, bps):
    """Uncompressed tiles of 16 to 80 by 16 to 64 pixels over two image
    sizes, chunky and planar: cv2 reads exactly the layouts whose tile
    fills a whole number of KiB, and the port with it."""
    rng = np.random.default_rng(spp * bps)
    read = 0
    for h, w in ((20, 40), (33, 70)):
        s = rng.integers(0, 256, (h, w, spp)).astype(np.uint8)
        if bps == 16:
            s = s.astype(np.uint16) * 257
        for tw in (16, 32, 48, 64, 80):
            for th in (16, 32, 64):
                for planar in ((1, 2) if spp > 1 else (1,)):
                    blob = write_tiff(s, 1 if spp == 1 else 2, bps,
                                      tile=(tw, th), planar=planar,
                                      extra=[1] if spp == 4 else None)
                    read += answers_as_cv2(blob) == "decoded"
    assert read


# ---------------------------------------------------------- ASAN mutants
_DECODE_MUTANTS = """
import ctypes, pickle, sys
import numpy as np
from onnxocr_tpu_torch.utils import imcodec
for attr, path, sigs in (("_LIB", sys.argv[1], imcodec._SIGNATURES),
                         ("_TIFF_LIB", sys.argv[2], imcodec._TIFF_SIGNATURES)):
    loaded = ctypes.CDLL(path)
    for name, (restype, argtypes) in sigs.items():
        getattr(loaded, name).restype = restype
        getattr(loaded, name).argtypes = argtypes
    setattr(imcodec, attr, loaded)
counts = {"decoded": 0, "none": 0, "raised": 0}
with open(sys.argv[3], "rb") as f:
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


def test_tiff_mutants_never_crash(tmp_path):
    """Seeded mutants (headers and data) of fax, JPEG-in-TIFF (YCbCr and
    grey, and grey or palette frames labelled 1, 4 or 16 bits a sample),
    YCbCr, CIELab, CMYK, BigTIFF, lossless JPEG (one scan, and a scan a
    component), planar YCbCr JPEG-in-TIFF, damaged LZW, old-style LZW and
    Deflate files decode to an image, None or a ValueError with both
    libraries built with AddressSanitizer."""
    import pickle
    import subprocess
    import sys
    from test_torch_imcodec import _mutant
    from test_torch_jpeg_lossless import lossless_jpeg
    from test_torch_tiff_recovery import (_strip_replaced, planar_jpeg,
                                          ticket_damaged)
    rng = np.random.default_rng(20)
    img = seeded_bits(8, 30, 70)
    seeds = [pil_tiff(Image.fromarray(img), compression=c,
                      tiffinfo={**i, 278: 7})
             for c, i in FAX.values()]
    rgb = _small_rgb()[:40, :60].copy()
    seeds += [pil_tiff(Image.fromarray(rgb), compression="jpeg"),
              pil_tiff(Image.fromarray(rgb).convert("L"), compression="jpeg"),
              _grey_jpeg_as(1, 1), _grey_jpeg_as(3, 4), _grey_jpeg_as(1, 16),
              pil_tiff(Image.fromarray(rgb).convert("YCbCr")),
              pil_tiff(Image.fromarray(rgb).convert("LAB")),
              pil_tiff(Image.fromarray(rgb).convert("CMYK"),
                       compression="tiff_lzw"),
              pil_tiff(Image.fromarray(rgb), big_tiff=True),
              lossless_jpeg([rgb[:, :, i].astype(np.int64) for i in range(3)],
                            predictor=4, restart_rows=5),
              lossless_jpeg([rgb[:, :, i].astype(np.int64) for i in range(3)],
                            predictor=[4, 1, 7], restart_rows=5,
                            scans=[[0], [1], [2]]),
              planar_jpeg(rgb),
              ticket_damaged(),
              _strip_replaced(pil_tiff(Image.fromarray(rgb),
                                       compression="tiff_lzw"), 0,
                              lambda d: b"\0\1" + d[2:]),
              pil_tiff(Image.fromarray(rgb), compression="tiff_deflate",
                       tiffinfo={278: 8, 317: 2})]
    # 31 mutants a seed (40 before the last five seeds came) keep the
    # sanitized run's time
    mutants = [_mutant(blob, rng) for blob in seeds for _ in range(31)]
    mutants += [m for blob in seeds[:6] for m in _fax_mutants(blob, rng, 20)]
    with open(tmp_path / "mutants.pkl", "wb") as f:
        pickle.dump(mutants, f)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    # -O0: the sanitized codec builds in a quarter of -O1's time
    flags = ["-std=c++17", "-shared", "-fPIC", "-O0", "-g"]
    asan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    if os.path.isabs(asan) and os.path.exists(asan):
        flags += ["-fsanitize=address", "-fno-omit-frame-pointer"]
        env.update(LD_PRELOAD=asan, ASAN_OPTIONS="detect_leaks=0")
    libs = []
    for src in (imcodec.SOURCE, imcodec.TIFF_SOURCE):
        lib = tmp_path / f"{src.stem}.so"
        libs.append(str(lib))
    procs = [subprocess.Popen(["g++", *flags, "-o", lib, str(src),
                               *native.EXTRA_FLAGS.get(src.name, [])])
             for lib, src in zip(libs, (imcodec.SOURCE, imcodec.TIFF_SOURCE))]
    assert all(p.wait(timeout=300) == 0 for p in procs)
    proc = subprocess.run(
        [sys.executable, "-c", _DECODE_MUTANTS, *libs,
         str(tmp_path / "mutants.pkl")], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    counts = eval(proc.stdout.strip().splitlines()[-1])
    assert sum(counts.values()) == len(mutants)
    assert counts["decoded"] and counts["none"], counts


# ------------------------------------------------------------- samples
SAMPLES = REPO / "onnxocr_tpu_torch" / "assets" / "samples"
TF_SAMPLES = ("sample_page_g4.tif", "sample_page_jpeg.tif",
              "sample_cmyk_lzw.tif", "sample_g3_2d_fill2.tif",
              "sample_lossless.jpg")


def write_samples(out=SAMPLES):
    """The committed scanned-document samples (how they were made): the
    corpus page big_doc (1280 x 960) binarised at 128 as PIL's Group 4 and
    as PIL's YCbCr JPEG-in-TIFF; ticket.jpg as a CMYK LZW TIFF and,
    binarised, as a T.4 2D TIFF with FillOrder 2; card.jpg's grey as a
    three-component lossless JPEG (predictor 4, restarts every 16 rows:
    cv2 5.0 refuses a one-component one at IMREAD_COLOR)."""
    from test_torch_jpeg_lossless import lossless_jpeg
    page = cv2.imread(str(PAGE / "big_doc.jpg"))
    ticket = cv2.imread(str(PAGE / "ticket.jpg"))
    card = cv2.imread(str(PAGE / "card.jpg"), cv2.IMREAD_GRAYSCALE)
    bw = lambda img: cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) > 128
    blobs = {
        "sample_page_g4.tif": pil_tiff(Image.fromarray(bw(page)),
                                       compression="group4"),
        "sample_page_jpeg.tif": pil_tiff(Image.fromarray(page[:, :, ::-1]),
                                         compression="jpeg"),
        "sample_cmyk_lzw.tif": pil_tiff(Image.fromarray(
            ticket[:, :, ::-1]).convert("CMYK"), compression="tiff_lzw"),
        "sample_g3_2d_fill2.tif": pil_tiff(
            Image.fromarray(bw(ticket)), compression="group3",
            tiffinfo={292: 1, 266: 2}),
        "sample_lossless.jpg": lossless_jpeg(
            [card.astype(np.int64)] * 3, predictor=4, restart_rows=16,
            ids=[82, 71, 66]),
    }
    for name, blob in blobs.items():
        (out / name).write_bytes(blob)
    return blobs


def test_scanned_samples_match_cv2_and_their_record():
    """The committed samples decode to cv2's decode here and to the shape
    and sha256 recorded in codec_samples.json, which the chip smoke's
    phase TF checks on a machine without cv2; each is under 300 KB."""
    import hashlib
    import json
    recorded = json.loads((SAMPLES / "codec_samples.json").read_text())
    for name in TF_SAMPLES:
        blob = (SAMPLES / name).read_bytes()
        assert len(blob) < 300_000 and recorded[name]["bytes"] == len(blob)
        assert answers_as_cv2(blob) == "decoded"
        got = imcodec.imdecode(blob)
        assert list(got.shape) == recorded[name]["shape"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == \
            recorded[name]["sha256"]
