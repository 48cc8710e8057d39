"""End-to-end smoke script of the port, as the root test_ocr.py is the JAX
package's: load the PP-OCRv5 pipeline (angle classifier on), OCR one page,
print the time and the first five results, and write the overlay.

    python -m onnxocr_tpu_torch.test_ocr [--device cuda|cpu]

The page is the one the JAX script looks for (the reference's
715873facf064583b44ef28295126fa7.jpg, in onnxocr_tpu/test_images/ or a
reference checkout at build/reference/onnxocr/test_images/), else the
committed onnxocr_tpu/test_images/doc_a.jpg (the JAX script exits there),
decoded with utils/imcodec. The overlay goes through `sav2Img` to
build/test_ocr/draw_ocr.jpg (the JAX script writes draw_ocr.jpg into the
working directory). Without the classifier's weights it fails as the JAX
script fails, unless ONNXOCR_TPU_ALLOW_UNTRAINED=1; the recognition
dictionary is found as the package finds it (ONNXOCR_TPU_ASSETS). Without
CUDA and without --device cpu it exits.
"""
import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
_NAME = "715873facf064583b44ef28295126fa7.jpg"
CANDIDATES = (REPO / "onnxocr_tpu" / "test_images" / _NAME,
              REPO / "build" / "reference" / "onnxocr" / "test_images" / _NAME,
              REPO / "onnxocr_tpu" / "test_images" / "doc_a.jpg")
OUT = REPO / "build" / "test_ocr" / "draw_ocr.jpg"


def find_test_image() -> Path:
    for c in CANDIDATES:
        if c.exists():
            return c
    print("no test image found", file=sys.stderr)
    sys.exit(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from .tools.eval_heldout import check_device
    check_device("test_ocr", args.device)

    from . import config as cfg
    from .pipeline.api import ONNXPaddleOcr, sav2Img
    from .utils import imcodec
    model = ONNXPaddleOcr(use_angle_cls=True, use_gpu=False,
                          device=args.device,
                          rec_char_dict_path=cfg.find_asset(
                              "ppocrv5/ppocrv5_dict.txt"))
    try:
        img = imcodec.imdecode(find_test_image().read_bytes())
        s = time.time()
        result = model.ocr(img)
        e = time.time()
        print("total time: {:.3f}".format(e - s))
        print("result:", result[0][:5], "..." if len(result[0]) > 5 else "")

        OUT.parent.mkdir(parents=True, exist_ok=True)
        sav2Img(img, result, name=str(OUT))
        print(f"saved {OUT.relative_to(REPO)}")
    finally:
        model.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
