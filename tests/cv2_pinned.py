"""cv2's float32 resizes computed in a child process whose IPP is pinned to
its AVX-512 code, and the host checks the other cv2 twins need.

cv2 5.0 hands float32 INTER_LINEAR and INTER_CUBIC resizes to IPP, whose
kernels differ with the host's ISA (OPENCV_IPP=avx512|avx2|sse42 select
one). The port's twins (onnxocr_tpu_torch/utils/cv_ops.py) follow the
AVX-512 code, so a test computes cv2's side of those resizes here: one
child per call, started with OPENCV_IPP=avx512, which first checks that
IPP took that code. The test process's own cv2 keeps the host's setting.
"""
import os
import pickle
import subprocess
import sys

import cv2

_CHILD = r"""
import pickle, sys
import cv2
version = cv2.ipp.getIppVersion()
if "AVX-512" not in version:
    sys.exit(f"IPP runs {version!r}, not its AVX-512 code: the port's "
             "float resize twins follow that code only")
jobs = pickle.load(sys.stdin.buffer)
pickle.dump([cv2.resize(img, size, interpolation=interp)
             for img, size, interp in jobs], sys.stdout.buffer)
"""


def resize_avx512(jobs):
    """[(float32 image, (w, h), cv2 interpolation flag)] → cv2.resize of
    each under OPENCV_IPP=avx512, in one child process."""
    env = dict(os.environ, OPENCV_IPP="avx512")
    done = subprocess.run([sys.executable, "-c", _CHILD],
                          input=pickle.dumps(list(jobs)), env=env,
                          capture_output=True, timeout=600)
    assert done.returncode == 0, done.stderr.decode(errors="replace")[-2000:]
    return pickle.loads(done.stdout)


def assert_ipp_avx512():
    """The JAX package's float resizes run in this process's cv2: equality
    with the port's twins needs IPP's AVX-512 code here too."""
    version = cv2.ipp.getIppVersion()
    assert "AVX-512" in version, (
        f"this host's IPP runs {version!r}; the port's float resize twins "
        "follow its AVX-512 code")


def assert_fma_dispatch():
    """cv2's remap and warpPerspective kernels use FMA in their AVX2 build
    (and above); its SSE builds round some values the other way."""
    avx2 = 11                      # cv2's CPU_AVX2 id
    assert cv2.checkHardwareSupport(avx2), (
        "cv2 runs without AVX2 here; the port's warp twin follows its AVX2 "
        "(FMA) kernels")
