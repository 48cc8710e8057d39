"""The public names the port took from the JAX package in one go, each held
against the JAX name on the CPU: `config.str2bool`, `config.make_params`
with its kwargs overlay and `_user_keys`, `utils.image.base64_to_cv2` (the
codec against cv2), the `utils` and package-root exports, `CTCLabelDecode`
(both input forms, `label`, `get_ignored_tokens`, `.dict`),
`ClsPostProcess(preds, label)`, the two Distillation classes,
`det_pre.det_resize_long_target`, `det_pre.normalize_pm1` (1e-6) and
`TextDetector.order_points_clockwise`. Everything else is exact.
"""
import base64

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import onnxocr_tpu
import onnxocr_tpu.utils as jutils
from onnxocr_tpu import config as jconfig
from onnxocr_tpu.ops import ctc as jctc
from onnxocr_tpu.ops import db_post as jdb_post
from onnxocr_tpu.ops import det_pre as jdet_pre
from onnxocr_tpu.pipeline.detector import TextDetector as JTextDetector
from onnxocr_tpu.utils.image import base64_to_cv2 as jbase64_to_cv2

import onnxocr_tpu_torch
import onnxocr_tpu_torch.utils as utils
from onnxocr_tpu_torch import config
from onnxocr_tpu_torch.ops import ctc, db_post, det_pre
from onnxocr_tpu_torch.pipeline.detector import TextDetector
from onnxocr_tpu_torch.utils.image import base64_to_cv2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_str2bool_matches_jax():
    for v in (True, False, "true", "True", "T", "t", "1", 1, 0, "0", "yes",
              "false", "", None, 1.0):
        assert config.str2bool(v) == jconfig.str2bool(v), v


def test_make_params_overlay_and_user_keys_match_jax():
    kw = dict(det_db_thresh=0.5, use_angle_cls=True, drop_score=0.1,
              tpu_pipeline="onecall")
    got, want = config.make_params(**kw), jconfig.make_params(**kw)
    assert got._user_keys == want._user_keys == set(kw)
    for k in kw:
        assert getattr(got, k) == getattr(want, k) == kw[k]
    shared = set(config.DEFAULTS) & set(jconfig.DEFAULTS)
    assert len(shared) > 50
    for k in shared:
        a, b = getattr(got, k), getattr(want, k)
        if isinstance(a, str) and a.startswith("/"):
            continue  # a path, under each package's own tree
        assert a == b, k
    # the no-argument form keeps working, with no key the caller's
    assert config.make_params()._user_keys == set()


def test_base64_to_cv2_matches_jax():
    rng = np.random.default_rng(0)
    img = cv2.GaussianBlur(rng.integers(0, 256, (30, 41, 3)).astype(
        np.uint8), (5, 5), 0)
    blobs = [bytes(cv2.imencode(ext, img)[1])
             for ext in (".png", ".jpg", ".bmp", ".webp")]
    blobs.append(rng.bytes(100))
    for blob in blobs:
        text = base64.b64encode(blob).decode()
        want, got = jbase64_to_cv2(text), base64_to_cv2(text)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)


def test_exports_match_jax():
    for name in ("get_rotate_crop_image", "get_minarea_rect_crop",
                 "resize_img", "base64_to_cv2", "draw_ocr", "text_visual",
                 "str_count", "str2bool", "make_params"):
        assert hasattr(jutils, name) and callable(getattr(utils, name))
    assert onnxocr_tpu_torch.__version__ == onnxocr_tpu.__version__
    assert sorted(onnxocr_tpu_torch.__all__) == sorted(onnxocr_tpu.__all__)
    boxes = [np.array([[x, y], [x + 20, y], [x + 20, y + 8], [x, y + 8]],
                      np.float32)
             for x, y in ((50, 10), (5, 12), (30, 40), (0, 41), (70, 9))]
    for a, b in zip(onnxocr_tpu_torch.sorted_boxes(boxes),
                    onnxocr_tpu.sorted_boxes(boxes)):
        np.testing.assert_array_equal(a, b)


def _probs(rng, n, t, v):
    x = rng.standard_normal((n, t, v)).astype(np.float32) * 3
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.fixture(scope="module")
def dict_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("dict") / "keys.txt"
    path.write_text("".join(chr(0x61 + i) + "\n" for i in range(20)))
    return str(path)


@pytest.mark.parametrize("space", [False, True])
def test_ctc_label_decode_matches_jax(dict_path, space):
    rng = np.random.default_rng(1)
    got = ctc.CTCLabelDecode(dict_path, space)
    want = jctc.CTCLabelDecode(dict_path, space)
    assert got.dict == want.dict
    assert got.get_ignored_tokens() == want.get_ignored_tokens() == [0]
    probs = _probs(rng, 3, 12, len(got.character))
    label = rng.integers(0, len(got.character), (3, 6))
    valid_t = [12, 7, 3]
    assert got(probs) == want(probs)
    assert got(torch.from_numpy(probs)) == want(probs)
    assert got(probs, valid_t=valid_t) == want(probs, valid_t=valid_t)
    assert got(probs, label=label) == want(probs, label=label)
    assert got([probs[:1], probs]) == want([probs[:1], probs])
    idx, prob = probs.argmax(2), probs.max(2)
    assert got((idx, prob)) == want((idx, prob))
    assert got((torch.from_numpy(idx), torch.from_numpy(prob)),
               label=torch.from_numpy(label)) == want((idx, prob),
                                                      label=label)


def test_cls_post_process_matches_jax():
    rng = np.random.default_rng(2)
    preds = _probs(rng, 1, 5, 2)[0]
    for labels in (None, ["0", "180"]):
        got = ctc.ClsPostProcess(labels)
        want = jctc.ClsPostProcess(labels)
        assert got(preds) == want(preds)
        assert got(torch.from_numpy(preds), label=None) == want(preds, None)


def test_distillation_ctc_label_decode_matches_jax(dict_path):
    rng = np.random.default_rng(3)
    v = 21
    preds = {"student": _probs(rng, 2, 9, v),
             "teacher": {"ctc": _probs(rng, 2, 9, v)},
             "keyed": {"head": _probs(rng, 2, 9, v)}}
    for kw in (dict(model_name=["student"]),
               dict(model_name="student"),
               dict(model_name=["teacher"], multi_head=True),
               dict(model_name=["keyed"], key="head")):
        got = ctc.DistillationCTCLabelDecode(dict_path, **kw)
        want = jctc.DistillationCTCLabelDecode(dict_path, **kw)
        assert got(preds) == want(preds)
    label = rng.integers(0, v, (2, 4))
    kw = dict(model_name=["student"])
    assert ctc.DistillationCTCLabelDecode(dict_path, **kw)(
        preds, label=label) == jctc.DistillationCTCLabelDecode(
            dict_path, **kw)(preds, label=label)


def test_distillation_db_post_process_matches_jax():
    rng = np.random.default_rng(4)
    maps = np.zeros((1, 1, 96, 160), np.float32)
    for _ in range(6):
        y, x = rng.integers(5, 80), rng.integers(5, 120)
        maps[0, 0, y:y + rng.integers(6, 14), x:x + rng.integers(15, 35)] = \
            rng.uniform(0.6, 0.95)
    predicts = {"student": {"maps": maps}, "student2": {"maps": maps * 0.9}}
    shape = np.array([[192, 320, 0.5, 0.5]])
    for kw in (dict(), dict(model_name=["student", "student2"],
                            box_thresh=0.5, use_dilation=True)):
        got = db_post.DistillationDBPostProcess(**kw)(predicts, shape)
        want = jdb_post.DistillationDBPostProcess(**kw)(predicts, shape)
        assert got.keys() == want.keys()
        assert all(len(r["points"]) for r in want["student"])
        for k in got:
            for g, w in zip(got[k], want[k]):
                np.testing.assert_array_equal(np.asarray(g["points"]),
                                              np.asarray(w["points"]))


def test_det_resize_long_target_and_normalize_pm1_match_jax():
    for h, w in ((1, 1), (31, 900), (480, 640), (2000, 37), (960, 960)):
        for long in (960, 640, 1280):
            assert det_pre.det_resize_long_target(h, w, long) == \
                jdet_pre.det_resize_long_target(h, w, long)
    x = np.random.default_rng(5).integers(0, 256, (2, 48, 80, 3)).astype(
        np.uint8)
    got = det_pre.normalize_pm1(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jdet_pre.normalize_pm1(
                                   jnp.asarray(x))), rtol=0, atol=1e-6)


def test_order_points_clockwise_matches_jax():
    rng = np.random.default_rng(6)
    for _ in range(20):
        pts = rng.uniform(0, 100, (4, 2)).astype(np.float32)
        np.testing.assert_array_equal(
            TextDetector.order_points_clockwise(None, pts),
            JTextDetector.order_points_clockwise(None, pts))
