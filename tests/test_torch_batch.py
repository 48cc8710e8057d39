"""The port's batch layer (onnxocr_tpu_torch/batch/: OCRLogic, the PDF
extractor and vector rasteriser) with its PIL twins (utils/pil_ops.py), the
CMYK/YCCK JPEG reading (utils/imcodec.py), the text panel of draw_ocr and
sav2Img, against PIL, cv2 and the JAX package on the CPU.

Tolerances: the PIL twins, the JPEG decodes, the rasterised pages (text
included: utils/font.py draws PIL's pixels), the text panel and the
sav2Img files are held value- and byte-equal; OCR results by the repo's
gate of tests/test_onecall.py — texts equal, boxes within 2 px, scores
within 2e-3; OCRLogic's txt and merged-txt contents equal. Every test of
tests/test_batch.py has a counterpart here (same name, `_port` suffix),
built on copies of its PDF builders.
"""
import glob
import io
import logging
import os
import shutil
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw, ImageFont

from onnxocr_tpu import ONNXPaddleOcr as JaxOcr
from onnxocr_tpu.batch import logic as jlogic
from onnxocr_tpu.batch import pdf as jpdf
from onnxocr_tpu.batch import pdf_raster as jraster
from onnxocr_tpu.pipeline import api as japi
from onnxocr_tpu.utils import draw as jdraw

import onnxocr_tpu_torch
from onnxocr_tpu_torch import ONNXPaddleOcr, config
from onnxocr_tpu_torch.batch import logic, pdf, pdf_raster
from onnxocr_tpu_torch.utils import draw, imcodec, pil_ops
from onnxocr_tpu_torch.utils.png import read_bgr

HELDOUT = config.ASSETS.parent / "test_images_heldout"
SMALL = dict(det_limit_side_len=640)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------ builders (test_batch.py)
def _make_scanned_pdf(path, img_rgb):
    """Minimal single-page PDF with one FlateDecode RGB image XObject."""
    h, w = img_rgb.shape[:2]
    raw = zlib.compress(img_rgb.tobytes())
    objs = []
    objs.append(b"1 0 obj\n<< /Type /Catalog /Pages 2 0 R >>\nendobj\n")
    objs.append(b"2 0 obj\n<< /Type /Pages /Kids [3 0 R] /Count 1 >>\n"
                b"endobj\n")
    objs.append(b"3 0 obj\n<< /Type /Page /Parent 2 0 R /Resources "
                b"<< /XObject << /Im0 4 0 R >> >> /MediaBox [0 0 612 792] "
                b"/Contents 5 0 R >>\nendobj\n")
    objs.append(
        b"4 0 obj\n<< /Type /XObject /Subtype /Image /Width " +
        str(w).encode() + b" /Height " + str(h).encode() +
        b" /ColorSpace /DeviceRGB /BitsPerComponent 8 /Filter /FlateDecode"
        b" /Length " + str(len(raw)).encode() + b" >>\nstream\n" + raw +
        b"\nendstream\nendobj\n")
    objs.append(b"5 0 obj\n<< /Length 40 >>\nstream\nq 612 0 0 792 0 0 cm "
                b"/Im0 Do Q\nendstream\nendobj\n")
    body = b"%PDF-1.4\n" + b"".join(objs) + b"%%EOF\n"
    with open(path, "wb") as f:
        f.write(body)


def _make_vector_pdf(path, content=None, fonts=(b"/Helvetica",)):
    content = content or (
        b"q 0.9 0.9 0.9 rg 40 600 500 80 re f 0 0 0 rg "
        b"BT /F1 24 Tf 60 700 Td (Hello Vector) Tj ET "
        b"BT /F1 14 Tf 60 610 Td 18 TL (first) Tj T* (second) ' ET")
    comp = zlib.compress(content)
    font_refs = b" ".join(b"/F%d %d 0 R" % (i + 1, 6 + i)
                          for i in range(len(fonts)))
    objs = [
        b"1 0 obj\n<< /Type /Catalog /Pages 2 0 R >>\nendobj\n",
        b"2 0 obj\n<< /Type /Pages /Kids [3 0 R] /Count 1 "
        b"/MediaBox [0 0 612 792] >>\nendobj\n",
        b"3 0 obj\n<< /Type /Page /Parent 2 0 R /Resources "
        b"<< /Font << " + font_refs + b" >> >> /Contents 5 0 R >>\n"
        b"endobj\n",
        b"5 0 obj\n<< /Length " + str(len(comp)).encode() +
        b" /Filter /FlateDecode >>\nstream\n" + comp +
        b"\nendstream\nendobj\n",
    ] + [b"%d 0 obj\n<< /Type /Font /Subtype /Type1 /BaseFont %s >>\n"
         b"endobj\n" % (6 + i, f) for i, f in enumerate(fonts)]
    with open(path, "wb") as f:
        f.write(b"%PDF-1.4\n" + b"".join(objs) + b"%%EOF\n")


def _make_mixed_pdf(path, img_rgb, img_filter=b"/FlateDecode",
                    cs=b"/DeviceRGB", extra_img=b"", img_bytes=None,
                    cm=b"300 0 0 200 100 400 cm"):
    """Single page: one image XObject placed by `cm` PLUS a text run —
    the mixed scanned-page case the rasterizer must compose."""
    h, w = img_rgb.shape[:2]
    if img_bytes is None:
        img_bytes = zlib.compress(img_rgb.tobytes())
    content = (b"q " + cm + b" /Im0 Do Q "
               b"BT /F1 24 Tf 60 700 Td (Mixed Page) Tj ET")
    comp = zlib.compress(content)
    objs = [
        b"1 0 obj\n<< /Type /Catalog /Pages 2 0 R >>\nendobj\n",
        b"2 0 obj\n<< /Type /Pages /Kids [3 0 R] /Count 1 "
        b"/MediaBox [0 0 612 792] >>\nendobj\n",
        b"3 0 obj\n<< /Type /Page /Parent 2 0 R /Resources "
        b"<< /Font << /F1 6 0 R >> /XObject << /Im0 4 0 R >> >> "
        b"/Contents 5 0 R >>\nendobj\n",
        b"4 0 obj\n<< /Type /XObject /Subtype /Image /Width " +
        str(w).encode() + b" /Height " + str(h).encode() +
        b" /ColorSpace " + cs + b" /BitsPerComponent 8 /Filter " +
        img_filter + extra_img +
        b" /Length " + str(len(img_bytes)).encode() + b" >>\nstream\n" +
        img_bytes + b"\nendstream\nendobj\n",
        b"5 0 obj\n<< /Length " + str(len(comp)).encode() +
        b" /Filter /FlateDecode >>\nstream\n" + comp +
        b"\nendstream\nendobj\n",
        b"6 0 obj\n<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>\n"
        b"endobj\n",
    ]
    with open(path, "wb") as f:
        f.write(b"%PDF-1.4\n" + b"".join(objs) + b"%%EOF\n")


def _cmyk_jpeg(rng, shape=(40, 60), adobe_transform=0):
    """A CMYK JPEG as PIL writes it (Adobe APP14, transform 0); with
    transform 2 the same data is read as YCCK."""
    cmyk = rng.integers(0, 256, shape + (4,), dtype=np.uint8)
    cmyk[:shape[0] // 2] //= 3
    buf = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(buf, "JPEG", quality=90)
    data = buf.getvalue()
    at = data.find(b"Adobe") + 11
    return data[:at] + bytes([adobe_transform]) + data[at + 1:]


def _same_pages(got, want):
    """Rasterised pages, value-equal."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------- PIL twins
@pytest.mark.parametrize("shape,size", [
    ((37, 53), (20, 90)), ((200, 150), (77, 61)), ((5, 7), (40, 5)),
    ((64, 64), (31, 64)), ((300, 41), (41, 123)), ((1, 9), (2, 3)),
    ((120, 90), (120, 90))])
def test_resize_bicubic_equals_pil(shape, size):
    rng = np.random.default_rng(shape[0])
    a = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    want = np.asarray(Image.fromarray(a).resize(size))
    np.testing.assert_array_equal(pil_ops.resize_bicubic(a, size), want)


@pytest.mark.parametrize("xy", [(3.7, 2.2, 10.9, 8.5), (-2.5, -0.5, 4.2, 3.9),
                                (5, 5, 5, 5), (10.2, 3.3, 60.1, 7.99),
                                (19, 0, 19, 11)])
def test_rectangle_and_new_equal_pil(xy):
    ref = Image.new("RGB", (20, 12), (255, 255, 255))
    ImageDraw.Draw(ref).rectangle(list(xy), fill=(1, 2, 3))
    got = pil_ops.new((20, 12), (255, 255, 255))
    pil_ops.rectangle(got, xy, (1, 2, 3))
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("xy", [(3, 4), (-5, 2), (15, 9), (30, 30)])
def test_paste_equals_pil(xy):
    rng = np.random.default_rng(sum(xy) + 40)
    dst = rng.integers(0, 256, (12, 20, 3), dtype=np.uint8)
    src = rng.integers(0, 256, (7, 9, 3), dtype=np.uint8)
    mask = rng.integers(0, 256, (7, 9), dtype=np.uint8)
    for m in (None, mask):
        ref = Image.fromarray(dst.copy())
        ref.paste(Image.fromarray(src), xy,
                  None if m is None else Image.fromarray(m))
        got = dst.copy()
        pil_ops.paste(got, src, xy, m)
        np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("coeffs,size", [
    ((0.7, 0.7, -3.2, -0.7, 0.7, 20.1), (40, 37)),     # rotation: fixed
    ((1.3, 0.0, 2.0, 0.0, -1.1, 30.0), (25, 30)),      # flip: scale path
    ((0.5, 0.2, 1.0, -0.3, 0.9, 2.0), (50, 40)),       # shear
    ((0.01, 0.7, 40000.0, 0.7, 0.02, -5.0), (30, 20)),  # float path
    ((0.02, 0.7, -40000.0, 0.7, 0.02, 3.0), (9, 40))])
def test_transform_affine_equals_pil(coeffs, size):
    rng = np.random.default_rng(int(size[0]))
    src = rng.integers(0, 256, (31, 29, 3), dtype=np.uint8)
    want = Image.fromarray(src).transform(size, Image.AFFINE, coeffs,
                                          resample=Image.BILINEAR)
    np.testing.assert_array_equal(
        pil_ops.transform_affine(src, size, coeffs, "bilinear"),
        np.asarray(want))
    mask = Image.new("L", (29, 31), 255).transform(size, Image.AFFINE, coeffs)
    np.testing.assert_array_equal(
        pil_ops.transform_affine(np.full((31, 29), 255, np.uint8), size,
                                 coeffs), np.asarray(mask))


# ------------------------------------------------------------ CMYK JPEG
@pytest.mark.parametrize("transform", [0, 2])
@pytest.mark.parametrize("shape", [(40, 60), (17, 9), (64, 48)])
def test_cmyk_ycck_jpeg_equals_cv2_and_pil(shape, transform):
    rng = np.random.default_rng(shape[0] + transform)
    data = _cmyk_jpeg(rng, shape, transform)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(imcodec.imdecode(data), want)
    pil = Image.open(io.BytesIO(data))
    assert pil.mode == "CMYK"
    np.testing.assert_array_equal(imcodec.jpeg_pil_rgb(data),
                                  np.asarray(pil.convert("RGB")))


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_jpeg_pil_rgb_grey_and_rgb(mode):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (33, 41, 3), dtype=np.uint8)
    img = Image.fromarray(a).convert(mode)
    buf = io.BytesIO()
    img.save(buf, "JPEG")
    np.testing.assert_array_equal(
        imcodec.jpeg_pil_rgb(buf.getvalue()),
        np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB")))
    assert imcodec.jpeg_pil_rgb(b"\xff\xd8\xff\xe0 nope") is None


# ---------------------------------------------------- text panel, sav2Img
def _result(rng, n=9, h=300, w=420):
    out = []
    for i in range(n):
        x, y = rng.uniform(0, w - 80), rng.uniform(0, h - 20)
        box = [[x, y], [x + 70, y + 3], [x + 68, y + 18], [x - 2, y + 15]]
        text = ["SCAN 12345", "office ffi", "中文 Hello", "AV To 7.",
                "a much longer line of recognized text that wraps " * 2,
                "<17><4203>", "¿Qué?", "x", "Total: 1,234.50"][i % 9]
        out.append([box, (text, float(rng.uniform(0.3, 1.0)))])
    return [out]


def test_wrap_rows_and_str_count_equal_jax():
    rng = np.random.default_rng(0)
    res = _result(rng, 30)[0]
    texts = [r[1][0] for r in res]
    scores = [r[1][1] for r in res]
    for budget in (26, 10, 3):
        assert draw._wrap_rows(texts, scores, 0.5, budget) == \
            jdraw._wrap_rows(texts, scores, 0.5, budget)
    for t in texts + ["", " 12 ab ", "全角ＡＢ"]:
        assert draw.str_count(t) == jdraw.str_count(t)


@pytest.mark.parametrize("n,h", [(9, 300), (40, 200), (0, 150)])
def test_draw_ocr_panel_equals_jax(n, h):
    """The page (cv2-exact resize + outlines) and the text panels (rows,
    wrap, pagination, glyphs) value-equal to the JAX package's."""
    rng = np.random.default_rng(n)
    page = rng.integers(0, 256, (h, 420, 3), dtype=np.uint8)
    res = _result(rng, n, h)[0]
    boxes = [r[0] for r in res]
    texts = [r[1][0] for r in res]
    scores = [r[1][1] for r in res]
    want = jdraw.draw_ocr(page, boxes, texts, scores)
    got = draw.draw_ocr(page, boxes, texts, scores)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    panels = (got.shape[1] - 600) // 600
    assert panels == max(1, -(-len(jdraw._wrap_rows(
        texts, scores, 0.5, 600 // 20 - 4)) // max(1, got.shape[0] // 25 - 1)))
    # no outlines without texts, same as the JAX package's
    np.testing.assert_array_equal(draw.draw_ocr(page, boxes),
                                  jdraw.draw_ocr(page, boxes))


def test_sav2img_bytes_equal_jax(tmp_path):
    """Fed the JAX package's own draw_ocr image, the port's encoder at
    quality 75 writes the bytes of the JAX sav2Img file (PIL's JPEG); the
    port's sav2Img writes that same file."""
    rng = np.random.default_rng(5)
    page = read_bgr(str(HELDOUT / "synth_00_doc.png"))
    res = _result(rng, 12, *page.shape[:2])
    jfile = str(tmp_path / "jax.jpg")
    japi.sav2Img(page, res, name=jfile)
    shown = jdraw.draw_ocr(page[:, :, ::-1], [l[0] for l in res[0]],
                           [l[1][0] for l in res[0]],
                           [l[1][1] for l in res[0]])
    with open(jfile, "rb") as f:
        assert imcodec.imencode_jpeg(shown[:, :, ::-1], quality=75) == \
            f.read()
    pfile = str(tmp_path / "port.jpg")
    onnxocr_tpu_torch.sav2Img(page, res, name=pfile)
    with open(pfile, "rb") as f, open(jfile, "rb") as g:
        assert f.read() == g.read()
    with pytest.raises(ValueError):
        onnxocr_tpu_torch.sav2Img(page, res, name=str(tmp_path / "x.png"))


# ----------------------------------------- counterparts of test_batch.py
def test_pdf_embedded_image_extraction_port(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (120, 100, 3), dtype=np.uint8)
    p = str(tmp_path / "scan.pdf")
    _make_scanned_pdf(p, img)
    pages = pdf.extract_embedded_images(p)
    assert len(pages) == 1
    np.testing.assert_array_equal(pages[0], img)
    _same_pages(pages, jpdf.extract_embedded_images(p))


def test_pdf_embedded_dct_and_cmyk_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (90, 120, 3), dtype=np.uint8)
    ok, jpg = cv2.imencode(".jpg", img)
    for name, data, cs in (("dct", jpg.tobytes(), b"/DeviceRGB"),
                           ("cmyk", _cmyk_jpeg(rng, (80, 70)),
                            b"/DeviceCMYK")):
        p = str(tmp_path / f"{name}.pdf")
        _make_mixed_pdf(p, img, img_filter=b"/DCTDecode", img_bytes=data,
                        cs=cs)
        _same_pages(pdf.extract_embedded_images(p),
                    jpdf.extract_embedded_images(p))


def test_pdf_vector_only_raises_port(tmp_path):
    p = str(tmp_path / "vector.pdf")
    with open(p, "wb") as f:
        f.write(b"%PDF-1.4\n1 0 obj\n<< /Type /Catalog >>\nendobj\n%%EOF")
    with pytest.raises(RuntimeError):
        pdf.pdf_to_images(p)


def test_result_to_text_shapes_port():
    log = logic.OCRLogic.__new__(logic.OCRLogic)  # no model init
    box = [[0, 0], [1, 0], [1, 1], [0, 1]]
    assert log._result_to_text([[[box, ("hi", 0.9)],
                                 [box, ("there", 0.8)]]]) == "hi\nthere"
    assert log._result_to_text([[]]) == "[未检测到内容]"
    assert log._result_to_text(None) == "[未检测到内容]"
    jax_log = jlogic.OCRLogic.__new__(jlogic.OCRLogic)
    for r in ([[[box, ("a", 0.5)], [0.1, 0.2], "odd"]], [[[box, ()]]], []):
        assert log._result_to_text(r) == jax_log._result_to_text(r)


def test_output_dir_beside_input_port(tmp_path):
    log = logic.OCRLogic.__new__(logic.OCRLogic)
    f = tmp_path / "img.jpg"
    f.write_bytes(b"x")
    out = log._get_output_dir(str(f))
    assert out == str(tmp_path / "Output_OCR")
    assert os.path.isdir(out)


def test_vector_pdf_rasterizes_port(tmp_path):
    p = str(tmp_path / "vec.pdf")
    _make_vector_pdf(p)
    pages = pdf.pdf_to_images(p)
    assert len(pages) == 1
    page = pages[0]
    assert page.ndim == 3 and page.shape[2] == 3
    assert (page < 128).any()
    assert (page == 255).mean() > 0.5
    _same_pages(pages, jpdf.pdf_to_images(p))


def test_raster_mixed_image_and_text_port(tmp_path):
    img = np.full((50, 80, 3), (200, 30, 30), np.uint8)
    p = str(tmp_path / "mixed.pdf")
    _make_mixed_pdf(p, img)
    pages = pdf_raster.render_pdf_pages(p, dpi=100)
    assert len(pages) == 1
    page = pages[0]
    red = (page[:, :, 0].astype(int) - page[:, :, 1].astype(int)) > 100
    assert red.sum() > 1000
    assert (page.max(axis=2) < 100).any()
    _same_pages(pages, jraster.render_pdf_pages(p, dpi=100))


def test_raster_image_jpeg_dct_port(tmp_path):
    img = np.full((40, 60, 3), (20, 160, 220), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=95)
    p = str(tmp_path / "jpeg.pdf")
    _make_mixed_pdf(p, img, img_filter=b"/DCTDecode",
                    img_bytes=buf.getvalue())
    page = pdf_raster.render_pdf_pages(p, dpi=100)[0]
    blue = (page[:, :, 2].astype(int) - page[:, :, 0].astype(int)) > 100
    assert blue.sum() > 1000
    _same_pages([page], jraster.render_pdf_pages(p, dpi=100))


@pytest.mark.parametrize("transform", [0, 2])
def test_raster_image_cmyk_jpeg_equals_jax(tmp_path, transform):
    rng = np.random.default_rng(7)
    p = str(tmp_path / "cmyk.pdf")
    _make_mixed_pdf(p, np.zeros((50, 70, 3), np.uint8),
                    img_filter=b"/DCTDecode", cs=b"/DeviceCMYK",
                    img_bytes=_cmyk_jpeg(rng, (50, 70), transform))
    got = pdf_raster.render_pdf_pages(p, dpi=100)
    want = jraster.render_pdf_pages(p, dpi=100)
    # the image area (outside the text run) is value-equal
    np.testing.assert_array_equal(got[0][200:, :], want[0][200:, :])
    _same_pages(got, want)


def test_raster_image_gray_predictor_port(tmp_path):
    h, w = 30, 40
    gray = (np.arange(h * w, dtype=np.uint8).reshape(h, w) % 200)
    rows = []
    prev = np.zeros((w,), np.int32)
    for r in range(h):
        cur = gray[r].astype(np.int32)
        rows.append(bytes([2]) + ((cur - prev) & 0xFF).astype(
            np.uint8).tobytes())
        prev = cur
    comp = zlib.compress(b"".join(rows))
    p = str(tmp_path / "pred.pdf")
    _make_mixed_pdf(p, np.stack([gray] * 3, -1), cs=b"/DeviceGray",
                    extra_img=b" /DecodeParms << /Predictor 15 /Colors 1 "
                              b"/Columns " + str(w).encode() + b" >>",
                    img_bytes=comp)
    page = pdf_raster.render_pdf_pages(p, dpi=100)[0]
    assert page.std() > 5
    _same_pages([page], jraster.render_pdf_pages(p, dpi=100))


@pytest.mark.parametrize("cm", [b"141 141 -141 141 300 300 cm",
                                b"300 0 0 -200 100 600 cm",
                                b"200 60 -40 150 120 300 cm"])
def test_raster_image_rotated_placement_port(tmp_path, cm):
    rng = np.random.default_rng(len(cm))
    img = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
    img[:, :, 1] = 180
    img[:, :, 0] = 10
    p = str(tmp_path / "rot.pdf")
    _make_mixed_pdf(p, img, cm=cm)
    page = pdf_raster.render_pdf_pages(p, dpi=100)[0]
    green = (page[:, :, 1].astype(int) - page[:, :, 0].astype(int)) > 100
    assert green.sum() > 1000
    want = jraster.render_pdf_pages(p, dpi=100)[0]
    # the transformed image is value-equal below the text run
    np.testing.assert_array_equal(page[160:], want[160:])


def test_raster_unsupported_filter_warns_and_skips_port(tmp_path, caplog):
    img = np.full((40, 60, 3), 128, np.uint8)
    p = str(tmp_path / "ccitt.pdf")
    _make_mixed_pdf(p, img, img_filter=b"/CCITTFaxDecode",
                    img_bytes=b"\x00" * 64)
    with caplog.at_level(logging.WARNING):
        pages = pdf_raster.render_pdf_pages(p, dpi=100)
    assert len(pages) == 1
    assert (pages[0].max(axis=2) < 100).any()
    assert any("CCITTFaxDecode" in r.message for r in caplog.records)


@pytest.mark.parametrize("filt", [b"/JBIG2Decode", b"/JPXDecode",
                                  b"/LZWDecode"])
def test_raster_other_unsupported_filters_port(tmp_path, filt):
    img = np.full((40, 60, 3), 128, np.uint8)
    p = str(tmp_path / "unsup.pdf")
    _make_mixed_pdf(p, img, img_filter=filt, img_bytes=b"\xff" * 32)
    pages = pdf_raster.render_pdf_pages(p, dpi=100)
    assert len(pages) == 1
    _same_pages(pages, jraster.render_pdf_pages(p, dpi=100))


def test_pdf_garbage_bytes_raise_cleanly_port(tmp_path):
    p = str(tmp_path / "garbage.pdf")
    with open(p, "wb") as f:
        f.write(b"%PDF-1.4\n" + np.random.default_rng(0).bytes(4096))
    with pytest.raises(RuntimeError):
        pdf.pdf_to_images(p)


def test_pdf_truncated_stream_degrades_port(tmp_path):
    img = np.full((50, 80, 3), 99, np.uint8)
    whole = zlib.compress(img.tobytes())
    p = str(tmp_path / "trunc.pdf")
    _make_mixed_pdf(p, img, img_bytes=whole[:len(whole) // 3])
    pages = pdf_raster.render_pdf_pages(p, dpi=100)
    assert len(pages) == 1
    assert (pages[0].max(axis=2) < 100).any()


def test_vector_pdf_fonts_and_operators_equal_jax(tmp_path):
    """Tf on the sans, serif and mono faces (and bold), Tj, TJ with
    kerning, ', TD/Tm and re f: the same page as the JAX package's, up to
    the glyph coverage."""
    content = (b"q 0.2 0.4 0.6 rg 30 500 200 40 re f Q "
               b"BT /F1 22 Tf 50 720 Td (Sans office 12345) Tj ET "
               b"BT /F2 18 Tf 50 690 Td [(Se) 120 (rif) -300 (AV)] TJ ET "
               b"BT /F3 16 Tf 14 TL 50 660 Td (Mono) Tj (line two) ' ET "
               b"BT /F4 20 Tf 1 0 0 1 50 620 Tm (Bold \\(x\\) \\101) Tj "
               b"0 -24 TD (next) Tj ET 1.5 g BT /F1 12 Tf 50 560 Td "
               b"(clipped ink) Tj ET")
    p = str(tmp_path / "fonts.pdf")
    _make_vector_pdf(p, content, (b"/Helvetica", b"/Times-Roman",
                                  b"/Courier", b"/Helvetica-Bold"))
    for dpi in (72, 150):
        _same_pages(pdf_raster.render_pdf_pages(p, dpi=dpi),
                    jraster.render_pdf_pages(p, dpi=dpi))


def test_batch_isolates_broken_pdf_port(tmp_path):
    good = str(tmp_path / "ok.png")
    cv2.imwrite(good, np.full((64, 64, 3), 255, np.uint8))
    bad = str(tmp_path / "broken.pdf")
    with open(bad, "wb") as f:
        f.write(b"%PDF-1.7\n\xde\xad\xbe\xef trailer garbage")

    class _Null:
        text_detector = None

        def ocr(self, img):
            return [[]]

    msgs = []
    log = logic.OCRLogic.__new__(logic.OCRLogic)  # no model init
    log.status_callback = msgs.append
    log.model = _Null()
    log._batching_enabled = True
    out = log.run([bad, good], save_txt=False, merge_txt=False)
    assert out[0] == ""
    assert any("read failed" in m and "broken.pdf" in m for m in msgs)
    assert out[1] == "[未检测到内容]"


def test_init_needs_cuda_or_device_cpu(monkeypatch):
    """OCRLogic runs on CUDA unless the caller passes device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        logic.OCRLogic(print)


# ------------------------------------------------------------ the slice
@pytest.fixture(scope="module")
def dict_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("dict") / "ppocrv5_dict.txt"
    path.write_text("".join(f"<{i}>\n" for i in range(18383)))
    return str(path)


@pytest.fixture(scope="module")
def models(dict_path):
    port = ONNXPaddleOcr(device="cpu", rec_char_dict_path=dict_path,
                         use_angle_cls=False, **SMALL)
    ref = JaxOcr(rec_char_dict_path=dict_path, use_angle_cls=False, **SMALL)
    yield port, ref
    port.close()


def _assert_same(got, ref):
    assert [l[1][0] for l in got] == [l[1][0] for l in ref]
    for g, r in zip(got, ref):
        assert np.abs(np.asarray(g[0], np.float64) -
                      np.asarray(r[0], np.float64)).max() <= 2.0
        assert abs(float(g[1][1]) - float(r[1][1])) < 2e-3


def test_scanned_pdf_ocr_e2e_port(tmp_path, models):
    """A scanned (image-only, rasterizer-path) PDF OCRs end-to-end: the
    line is found, with the JAX package's texts and boxes."""
    port, ref = models
    scan = Image.new("RGB", (612, 300), (250, 250, 250))
    ImageDraw.Draw(scan).text(
        (60, 120), "SCAN 12345", fill=(10, 10, 10),
        font=ImageFont.truetype(
            "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf", 42))
    p = str(tmp_path / "scan_e2e.pdf")
    _make_mixed_pdf(p, np.asarray(scan), cm=b"612 0 0 300 0 492 cm")
    page = pdf_raster.render_pdf_pages(p, dpi=150)[0]
    _same_pages([page], jraster.render_pdf_pages(p, dpi=150))
    bgr = np.ascontiguousarray(page[:, :, ::-1])
    got, want = port.ocr(bgr)[0], ref.ocr(bgr)[0]
    assert len(got) >= 1
    _assert_same(got, want)


def test_vector_pdf_page_ocr_equals_pil_render(tmp_path, models):
    """The OCR-level check of the font: a vector page rendered by the port
    and by the JAX package (PIL) gives the same texts, boxes within 2 px,
    through the same pipeline."""
    port, _ = models
    content = (b"BT /F1 30 Tf 60 700 Td (Invoice 2024-117) Tj ET "
               b"BT /F1 24 Tf 60 640 Td (Total: 1,234.50 EUR) Tj ET "
               b"BT /F2 26 Tf 60 580 Td [(Wa) 80 (ter AV To)] TJ ET")
    p = str(tmp_path / "ocr_vec.pdf")
    _make_vector_pdf(p, content, (b"/Helvetica", b"/Times-Bold"))
    mine = pdf_raster.render_pdf_pages(p, dpi=100)[0][:, :, ::-1]
    pil = jraster.render_pdf_pages(p, dpi=100)[0][:, :, ::-1]
    got = port.ocr(np.ascontiguousarray(mine))[0]
    want = port.ocr(np.ascontiguousarray(pil))[0]
    assert len(got) >= 3
    assert [l[1][0] for l in got] == [l[1][0] for l in want]
    for g, r in zip(got, want):
        assert np.abs(np.asarray(g[0]) - np.asarray(r[0])).max() <= 2.0


def _inputs(root):
    """Two held-out pages (PNG, and one re-encoded as JPEG), a scanned PDF
    of one, a vector PDF and a broken PDF, in `root`."""
    os.makedirs(root, exist_ok=True)
    files = []
    src = str(HELDOUT / "synth_00_doc.png")
    files.append(shutil.copy(src, os.path.join(root, "page_a.png")))
    page = read_bgr(str(HELDOUT / "synth_08_table.png"))
    jpg = os.path.join(root, "page_b.jpg")
    with open(jpg, "wb") as f:
        f.write(imcodec.imencode_jpeg(page, quality=90))
    files.append(jpg)
    scan = os.path.join(root, "scan.pdf")
    _make_scanned_pdf(scan, np.ascontiguousarray(read_bgr(src)[:, :, ::-1]))
    files.append(scan)
    vec = os.path.join(root, "vec.pdf")
    _make_vector_pdf(vec)
    files.append(vec)
    bad = os.path.join(root, "broken.pdf")
    with open(bad, "wb") as f:
        f.write(b"%PDF-1.7\n\xde\xad garbage")
    files.append(bad)
    return files


def _texts(root):
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "Output_OCR", "*.txt"))):
        key = os.path.basename(path).rsplit("_ocr_", 1)[0]
        with open(path, encoding="utf-8") as f:
            out[key] = f.read()
    return out


def test_ocrlogic_txt_and_merged_equal_jax(tmp_path, models):
    port, ref = models
    runs = {}
    for name, cls, model in (("port", logic.OCRLogic, port),
                             ("jax", jlogic.OCRLogic, ref)):
        root = str(tmp_path / name)
        files = _inputs(root)
        msgs = []
        log = cls.__new__(cls)   # as tests/test_batch.py builds one
        log.status_callback = msgs.append
        log.model = model
        log._batching_enabled = name == "jax"
        all_text = log.run(files, save_txt=True, merge_txt=True,
                           output_img=True)
        runs[name] = (root, all_text, msgs)
    (proot, ptext, pmsgs), (jroot, jtext, jmsgs) = runs["port"], runs["jax"]
    assert ptext == jtext
    assert _texts(proot) == _texts(jroot)
    assert set(_texts(proot)) == {"page_a", "page_b", "scan", "vec",
                                  "merged"}
    assert any("read failed" in m and "broken.pdf" in m for m in pmsgs)
    # overlays: the port's JPEGs decode at the JAX overlays' sizes
    jpgs = sorted(glob.glob(os.path.join(proot, "Output_OCR", "*.jpg")))
    assert [os.path.basename(j) for j in jpgs] == sorted(
        os.path.basename(j) for j in glob.glob(
            os.path.join(jroot, "Output_OCR", "*.jpg")))
    assert len(jpgs) == 4
    for j in jpgs:
        got = imcodec.imdecode(open(j, "rb").read())
        want = cv2.imread(j.replace(proot, jroot))
        assert got.shape == want.shape
        # the text panel's black 1 px right border
        assert got.shape[1] > 600 and (got[:, -1] < 96).mean() > 0.9
    # the port's run enabled its cross-page det batcher
    assert port.text_detector._page_batcher is not None
