"""The one-call wave coalescer of the port vs the JAX package on the CPU.

The multi-page step (`OneCallPipeline.step_wave`) against the JAX
package's vmapped batch program (`_get_batched`) on the same two pages,
with the classifier off and on (the seeded untrained classifier, "180"
first and cls_thresh 0.5, so that its verdicts turn crops): per page, the
same valid rows, quads within 1e-3 px, texts equal and scores within 2e-3.
Then the coalescer in the port: a pair held back with `_hold` and released
runs as one wave whose results equal the single-page program's at
tpu_warp_stage='off' (the wave warps with the gather), a lone request runs
batch 1 through the single-page step in the shear form, and, on a stub
pipeline, the dispatch rules: no tier before its warm, the largest warm
tier at most the backlog, a background warm on the first backlog, a failed
warm kept in stats and the tier cold, an error reaching every caller of a
wave, close() stopping the thread.

Pages: two 320 × 640 parts of committed held-out pages (one source
bucket), det limit 640; the dictionary is a stand-in
(tests/test_torch_host_det.py).
"""
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from onnxocr_tpu import ONNXPaddleOcr as JaxOcr

from onnxocr_tpu_torch import ONNXPaddleOcr, config
from onnxocr_tpu_torch.ops import resize_dev
from onnxocr_tpu_torch.pipeline.onecall import _WaveCoalescer
from onnxocr_tpu_torch.utils.png import read_bgr

HELDOUT = config.ASSETS.parent / "test_images_heldout"
BASE = dict(det_limit_side_len=640, drop_score=0.0, tpu_pipeline="onecall",
            tpu_onecall_max_boxes=16,
            use_angle_cls=True, tpu_allow_untrained=True,
            label_list=["180", "0"], cls_thresh=0.5)
WAVE = dict(BASE, tpu_onecall_wave=True, tpu_onecall_wave_tiers="2")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Test processes run side by side on the machine's cores: two torch
    threads keep this module from oversubscribing them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pages():
    a = read_bgr(str(HELDOUT / "synth_00_doc.png"))[0:320, 0:640]
    b = read_bgr(str(HELDOUT / "synth_08_table.png"))[100:420, 100:740]
    return [np.ascontiguousarray(a), np.ascontiguousarray(b)]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(port with waves, port single-page at the gather warp, JAX package)
    on the CPU; the port's coalescer thread is stopped at the end."""
    path = tmp_path_factory.mktemp("dict") / "ppocrv5_dict.txt"
    path.write_text("".join(f"<{i}>\n" for i in range(18383)))
    kw = dict(rec_char_dict_path=str(path))
    wave = ONNXPaddleOcr(device="cpu", **WAVE, **kw)
    single = ONNXPaddleOcr(device="cpu", tpu_warp_stage="off", **BASE, **kw)
    yield wave, single, JaxOcr(**BASE, **kw)
    wave.close()
    assert not wave._onecall._wave._thread.is_alive()


def _uploads(oc, pages):
    """The pages uploaded as the one-call path uploads them → (images (B,
    Hs, Ws, 3), src_h, src_w, rh, rw lists, (hb, wb, eh, ew))."""
    ups = [resize_dev.put_src_bucket(p, "cpu") for p in pages]
    canv = [oc.canvas(h, w) for _, h, w in ups]
    assert len({c[1:] for c in canv}) == 1
    (hb, wb), (eh, ew) = canv[0][1:]
    return (torch.stack([u[0] for u in ups]), [u[1] for u in ups],
            [u[2] for u in ups], [c[0][0] for c in canv],
            [c[0][1] for c in canv], (hb, wb, eh, ew))


def _texts_scores(res):
    return [r[0] for r in res], np.asarray([r[1] for r in res])


@pytest.mark.parametrize("use_cls", [False, True], ids=["cls_off", "cls_on"])
def test_step_wave_matches_jax(models, pages, use_cls):
    """The port's one-download wave buffer, page by page, against the JAX
    package's `_get_batched` output on the same uploaded pages: the same
    valid rows and n_valid, quads within 1e-3, the decoded texts equal and
    scores within 2e-3."""
    port, _, ref = models
    oc, joc = port._onecall, ref._onecall
    images, sh, sw, rh, rw, (hb, wb, eh, ew) = _uploads(oc, pages)
    out = oc.step_wave(images, sh, sw, rh, rw, hb, wb, eh, ew,
                       use_cls).numpy()
    fn = joc._get_batched(use_cls, len(pages), hb, wb, eh, ew)
    i32 = jnp.int32
    jout = np.asarray(fn(*joc._params(use_cls), jnp.asarray(images.numpy()),
                         jnp.array(sh, i32), jnp.array(sw, i32),
                         jnp.array(rh, i32), jnp.array(rw, i32)))
    assert out.shape == jout.shape
    k = oc.k_rec
    rotated = 0
    for b in range(len(pages)):
        valid = out[b, :k, 9] > 0.5
        assert out[b, k, 0] == jout[b, k, 0] >= 4
        np.testing.assert_array_equal(valid, jout[b, :k, 9] > 0.5)
        np.testing.assert_allclose(out[b, :k, :8][valid],
                                   jout[b, :k, :8][valid], rtol=0, atol=1e-3)
        _, got = oc.decode_packed(out[b], images[b], use_cls)
        _, want = joc._decode_packed(jout[b], None, use_cls)
        (gt, gs), (wt, ws) = _texts_scores(got), _texts_scores(want)
        assert gt == wt
        assert np.abs(gs - ws).max() < 2e-3
        if use_cls:
            plain = oc.step_wave(images, sh, sw, rh, rw, hb, wb, eh, ew,
                                 False).numpy()
            rotated += _texts_scores(oc.decode_packed(
                plain[b], images[b], False)[1])[0] != gt
    if use_cls:
        assert rotated, "the classifier turned no crop"


def _assert_close(got, ref):
    assert [l[1][0] for l in got] == [l[1][0] for l in ref]
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert np.abs(np.asarray(g[0], np.float64) -
                      np.asarray(r[0], np.float64)).max() <= 1e-3
        assert abs(float(g[1][1]) - float(r[1][1])) < 2e-3


def _run_held(model, pages):
    """ocr() of each page from its own thread while the dispatcher is held,
    released once every page is queued → results in page order."""
    wave = model._onecall._wave
    wave._hold = True
    results = [None] * len(pages)

    def run(i):
        results[i] = model.ocr(pages[i])[0]

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(pages))]
    for t in threads:
        t.start()
    deadline = time.time() + 60
    while len(wave._queue) < len(pages) and time.time() < deadline:
        time.sleep(0.01)
    assert len(wave._queue) == len(pages)
    with wave._cv:
        wave._hold = False
        wave._cv.notify_all()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    return results


def test_coalesced_pair_matches_single(models, pages):
    """Two pages queued together run as one wave of 2 once that tier is
    warmed; each page's result equals the single-page program's at the
    gather warp (quads 1e-3, scores 2e-3), as the JAX package's
    tests/test_onecall_wave.py holds its own."""
    port, single, _ = models
    wave = port._onecall._wave
    images, *_, (hb, wb, eh, ew) = _uploads(port._onecall, pages)
    wave.warm_sync(True, images.shape[1:], hb, wb, 2, eh, ew)
    assert ((True, tuple(images.shape[1:]), hb, wb, eh, ew), 2) in \
        wave._ready and not wave.stats["warm_errors"]
    before = wave.stats["waves"].get(2, 0)
    got = _run_held(port, pages)
    assert wave.stats["waves"].get(2, 0) == before + 1
    for g, page in zip(got, pages):
        _assert_close(g, single.ocr(page)[0])


def test_lone_request_runs_batch1_in_the_shear_form(models, pages,
                                                    monkeypatch):
    """A lone page is dispatched at once, batch 1, through the single-page
    step in the configured (shear) warp form: its result is the one-call
    program's without the coalescer, and its texts the gather form's."""
    port, single, _ = models
    oc = port._onecall
    assert oc.fused.warp_form["staged"] == "shear"
    steps = []
    monkeypatch.setattr(oc, "step", lambda *a, f=oc.step: steps.append(1)
                        or f(*a))
    before = oc._wave.stats["waves"].get(1, 0)
    got = port.ocr(pages[0])[0]
    assert oc._wave.stats["waves"][1] == before + 1 and steps == [1]
    monkeypatch.setattr(oc, "_wave", None)
    assert port.ocr(pages[0])[0] == got and steps == [1, 1]
    want = single.ocr(pages[0])[0]
    assert [l[1][0] for l in got] == [l[1][0] for l in want]


# ------------------------------------------------ dispatch rules (a stub)
class _StubPipe:
    """The coalescer's view of OneCallPipeline: each page's buffer is its
    own first pixel; `fail` makes the next multi-page runs raise; a warm
    (all pages zero) waits for `warm_gate`."""

    device = torch.device("cpu")

    def __init__(self):
        self.single, self.waves, self.warms = [], [], []
        self.fail = None
        self.warm_gate = threading.Event()
        self.warm_gate.set()

    def _run_single(self, use_cls, image, *args):
        self.single.append(int(image[0, 0, 0]))
        return np.full(3, float(image[0, 0, 0]), np.float32)

    def step_wave(self, images, *args):
        if self.fail is not None:
            raise self.fail
        firsts = images[:, 0, 0, 0].to(torch.float32)
        if not firsts.any():
            assert self.warm_gate.wait(10)
            self.warms.append(len(images))
        else:
            self.waves.append(len(images))
        return firsts[:, None].repeat(1, 3)


@pytest.fixture
def stub():
    pipe = _StubPipe()
    wave = _WaveCoalescer(pipe, [2, 4])
    yield pipe, wave
    wave.close()
    assert not wave._thread.is_alive()


def _held(wave, values, key_extra=0):
    """run() of one page per value (its first pixel), from threads, while
    the dispatcher is held → (results or errors in order)."""
    wave._hold = True
    out = [None] * len(values)

    def run(i):
        img = torch.full((4, 4, 3), values[i], dtype=torch.uint8)
        try:
            out[i] = wave.run(False, img, 4, 4, 4, 4, 32 + key_extra, 32)
        except Exception as e:  # the test reads it
            out[i] = e

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(values))]
    for t in threads:
        t.start()
    deadline = time.time() + 10
    while len(wave._queue) < len(values) and time.time() < deadline:
        time.sleep(0.005)
    assert len(wave._queue) == len(values)
    with wave._cv:
        wave._hold = False
        wave._cv.notify_all()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    return out


def _wait_warms(wave):
    deadline = time.time() + 10
    while wave._warming and time.time() < deadline:
        time.sleep(0.005)
    assert not wave._warming


def test_no_tier_before_its_warm(stub):
    """A backlog of 3 before any warm runs as 3 single pages and starts one
    background warm of tier 2; after it, 3 queued pages run as a wave of 2
    and one single page, each caller getting its own buffer; warm_sync of
    tier 4 makes a backlog of 5 run 4 + 1."""
    pipe, wave = stub
    pipe.warm_gate.clear()
    out = _held(wave, [1, 2, 3])
    assert [o[0] for o in out] == [1, 2, 3]
    assert sorted(pipe.single) == [1, 2, 3] and pipe.waves == []
    assert pipe.warms == [] and len(wave._warming) == 1
    pipe.warm_gate.set()
    _wait_warms(wave)
    assert pipe.warms == [2] and not wave.stats["warm_errors"]
    out = _held(wave, [4, 5, 6])
    assert [o[0] for o in out] == [4, 5, 6]
    assert pipe.waves == [2] and len(pipe.single) == 4
    wave.warm_sync(False, (4, 4, 3), 32, 32, 4)
    out = _held(wave, [7, 8, 9, 10, 11])
    assert [o[0] for o in out] == [7, 8, 9, 10, 11]
    assert pipe.waves == [2, 4] and len(pipe.single) == 5
    assert wave.stats["pages"] == 11
    assert wave.stats["waves"] == {1: 5, 2: 1, 4: 1}


def test_other_keys_do_not_join_a_wave(stub):
    """Pages of another canvas (another key) run apart."""
    pipe, wave = stub
    wave.warm_sync(False, (4, 4, 3), 32, 32, 2)
    out = _held(wave, [1, 2], key_extra=0)
    assert pipe.waves == [2]
    wave._hold = True
    results = []
    ts = [threading.Thread(target=lambda v=v, e=e: results.append(
        wave.run(False, torch.full((4, 4, 3), v, dtype=torch.uint8), 4, 4,
                 4, 4, 32 + e, 32)[0])) for v, e in ((3, 0), (4, 320))]
    for t in ts:
        t.start()
    while len(wave._queue) < 2:
        time.sleep(0.005)
    with wave._cv:
        wave._hold = False
        wave._cv.notify_all()
    for t in ts:
        t.join(timeout=10)
    assert sorted(results) == [3, 4] and pipe.waves == [2]
    assert [o[0] for o in out] == [1, 2]


def test_wave_error_reaches_every_caller(stub):
    """A wave that raises raises in each of its callers; a failed warm
    leaves its tier cold, keeps its error in stats, and the requests run
    single."""
    pipe, wave = stub
    wave.warm_sync(False, (4, 4, 3), 32, 32, 2)
    pipe.fail = ValueError("boom")
    out = _held(wave, [1, 2])
    assert all(isinstance(o, ValueError) for o in out)
    wave.warm_sync(False, (4, 4, 3), 32, 32, 4)
    assert len(wave.stats["warm_errors"]) == 1
    assert "boom" in wave.stats["warm_errors"][0]
    pipe.fail = None
    out = _held(wave, [3, 4, 5, 6])
    assert [o[0] for o in out] == [3, 4, 5, 6]
    assert pipe.waves == [2, 2]


def test_close_stops_the_thread():
    wave = _WaveCoalescer(_StubPipe(), [2])
    assert wave._thread.is_alive()
    wave.close()
    assert not wave._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        wave.run(False, torch.zeros((4, 4, 3), dtype=torch.uint8), 4, 4, 4,
                 4, 32, 32)
