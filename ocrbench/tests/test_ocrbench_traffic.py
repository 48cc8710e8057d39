"""The generator: the same requests for the same seed, others for
another, and every seed the same set of page properties."""
import numpy as np

from ocrbench import spec
from ocrbench.gen import png, traffic as gen
from conftest import tiny


def _pages(seed):
    return gen.make(tiny(spec.load("v5-scans")).traffic, seed)


def test_same_seed_same_pages():
    a, b = _pages(2 ** 31 + 5), _pages(2 ** 31 + 5)
    assert a.payloads == b.payloads
    assert all((x == y).all() for x, y in zip(a.images, b.images))


def test_other_seed_same_pages_in_another_order():
    a, b = _pages(11), _pages(12)
    assert a.payloads != b.payloads
    assert sorted(a.payloads) == sorted(b.payloads)


def test_png_round_trip():
    from onnxocr_tpu_torch.utils import imcodec
    img = _pages(3).images[0]
    out = imcodec.imdecode(png.encode(img))
    assert out.shape == img.shape + (3,)
    assert (out[:, :, 0] == img).all() and (out[:, :, 2] == img).all()


def test_lines_same_seed_same_lines():
    cell = spec.load("v5-scans")
    t = dict(cell.traffic)
    t.update({"kind": "lines", "pool": 2, "per_request": 4, "chars": [4, 30],
              "height": [32, 64], "em_of_height": 0.7})
    a, b, c = gen.make(t, 1), gen.make(t, 1), gen.make(t, 2)
    flat = lambda tr: [x for r in tr.payloads for x in r]  # noqa: E731
    assert all((x == y).all() for x, y in zip(flat(a), flat(b)))
    assert any(x.shape != y.shape or (x != y).any()
               for x, y in zip(flat(a), flat(c)))
    heights = sorted(x.shape[0] for x in flat(a))
    assert heights == sorted(x.shape[0] for x in flat(c))
    assert 32 <= heights[0] and heights[-1] <= 64
    assert all(x.dtype == np.uint8 and x.ndim == 3 for x in flat(a))
