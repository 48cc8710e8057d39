"""The port's float32 resize twins (utils/cv_ops.resize_cubic and
resize_linear on float32 images) against cv2 5.0 value for value.

cv2 hands these resizes to IPP, whose float kernels differ with the host's
ISA; the twins follow its AVX-512 code, and cv2's side of every case is
computed in one child process started with OPENCV_IPP=avx512, which
checks that IPP took that code (tests/cv2_pinned.py).

* INTER_CUBIC (IPP from 4 px a side): the callers' shapes — 4 × 4 → 320²
  and 640² (train/synth.det_page_hard), 4 × 4 → every
  tools/make_test_corpus.PAGES page — and 48 seeded shapes of 4–120 px
  to 4–400 px, upscales and downscales, 1 and 3 channels, values 40–230.
* INTER_LINEAR: seeded horizontal upscales of 8–16× (and the two of 13×
  and 15× that once showed one-ulp values), 1 and 3 channels, and seeded
  shapes of either kind.
"""
import numpy as np
import pytest
import torch

import cv2

from onnxocr_tpu_torch.tools.make_test_corpus import PAGES
from onnxocr_tpu_torch.utils import cv_ops

from cv2_pinned import resize_avx512


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cases():
    """(name, float32 image, (w, h), cv2 flag)."""
    rng = np.random.default_rng(20260)
    cases = []

    def image(h, w, c, lo=40, hi=230):
        shape = (h, w) if c == 1 else (h, w, c)
        return rng.uniform(lo, hi, shape).astype(np.float32)

    for size in (320, 640):
        cases.append((f"hard_page_{size}", image(4, 4, 3), (size, size),
                      cv2.INTER_CUBIC))
    for name, (H, W), *_ in PAGES:
        cases.append((f"corpus_{name}", image(4, 4, 3, 60, 220), (W, H),
                      cv2.INTER_CUBIC))
    for i in range(48):
        h, w = (int(v) for v in rng.integers(4, 121, 2))
        if i % 2:                          # enlarge
            size = (int(rng.integers(w, 401)), int(rng.integers(h, 401)))
        else:                              # reduce (or keep) either axis
            size = (int(rng.integers(4, w + 1)), int(rng.integers(4, 401)))
        c = 3 if i % 4 < 2 else 1
        cases.append((f"cubic{i}_{c}ch", image(h, w, c), size,
                      cv2.INTER_CUBIC))
    for name, (h, w), size in (("13x", (24, 21), (313, 262)),
                               ("15x", (140, 30), (388, 290))):
        for c in (1, 3):
            cases.append((f"linear_{name}_{c}ch", image(h, w, c), size,
                          cv2.INTER_LINEAR))
    for i in range(16):
        h, w = (int(v) for v in rng.integers(2, 60, 2))
        f = 8 + 8 * i / 15                 # 8× to 16× across
        size = (max(1, int(w * f)), int(rng.integers(2, 400)))
        c = 3 if i % 2 else 1
        cases.append((f"linear_wide{i}_{c}ch", image(h, w, c), size,
                      cv2.INTER_LINEAR))
    for i in range(16):
        h, w = (int(v) for v in rng.integers(2, 200, 2))
        size = tuple(int(v) for v in rng.integers(2, 500, 2))
        c = 3 if i % 2 else 1
        cases.append((f"linear{i}_{c}ch", image(h, w, c), size,
                      cv2.INTER_LINEAR))
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def cv2_side():
    return resize_avx512((img, size, flag) for _, img, size, flag in CASES)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_float_resize_matches_cv2(cv2_side, case):
    _, img, size, flag = CASES[case]
    twin = cv_ops.resize_cubic if flag == cv2.INTER_CUBIC else \
        cv_ops.resize_linear
    got, want = twin(img, size), cv2_side[case]
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
