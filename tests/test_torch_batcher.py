"""The cross-request batchers of the port's default pipeline vs the JAX
package on the CPU: the generic MicroBatcher, the pieces of the multi-page
passes (the gather warp from a stack of pages, the per-page quad scores),
the det batcher's wave, the fused multi-page steps, and the slice:
`ONNXPaddleOcr(tpu_det_microbatch=True, tpu_rec_microbatch=True)` called
from several threads at once, as the JAX package's serving engine calls one
model, on both sides.

The recognition dictionary is not in the repository: both sides read a
stand-in (tests/test_torch_host_det.py). Slice tolerances are those of
tests/test_onecall.py: texts equal, boxes within 2 px, scores within 2e-3.
Every batcher a test starts is closed, and its thread joined, at the end.
"""
import math
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from onnxocr_tpu import ONNXPaddleOcr as JaxOcr
from onnxocr_tpu.ops import db_device as jdb_device
from onnxocr_tpu.ops import warp as jwarp

from onnxocr_tpu_torch import ONNXPaddleOcr, config
from onnxocr_tpu_torch.ops import db_device, det_pre, resize_dev, warp
from onnxocr_tpu_torch.runtime.batcher import MicroBatcher, RecCropBatcher
from onnxocr_tpu_torch.utils.png import read_bgr

HELDOUT = config.ASSETS.parent / "test_images_heldout"
PAGES = ("synth_00_doc", "synth_03_doc", "synth_08_table")
SMALL = dict(det_limit_side_len=320, drop_score=0.0)
BATCHED = dict(SMALL, tpu_det_microbatch=True, tpu_rec_microbatch=True,
               tpu_microbatch_wait_ms=200)
# the untrained classifier (same seeded weights on both sides) with the
# "180" label first and the threshold at 0.5: its verdicts turn crops
FLIP = dict(use_angle_cls=True, tpu_allow_untrained=True,
            label_list=["180", "0"], cls_thresh=0.5)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Test processes run side by side on the machine's cores: two torch
    threads keep this module from oversubscribing them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _in_threads(fn, args):
    """fn over args, one thread each → results (or the exception raised)
    in args order."""
    with ThreadPoolExecutor(len(args)) as pool:
        futures = [pool.submit(fn, a) for a in args]
        return [f.exception(timeout=300) or f.result() for f in futures]


def _closed(*batchers):
    for b in batchers:
        b.close()
        threads = [b._thread] if hasattr(b, "_thread") else \
            [b.batcher._thread]
        assert not any(t.is_alive() for t in threads)


# ---------------------------------------------------------- MicroBatcher
@pytest.fixture
def make_batcher():
    """MicroBatcher(...) whose thread is stopped after the test."""
    made = []

    def make(fn, **kw):
        made.append(MicroBatcher(fn, **kw))
        return made[-1]

    yield make
    _closed(*made)


LEAVES = {
    "numpy": lambda a: a,
    "tensor": torch.from_numpy,
    "tree": lambda a: {"x": torch.from_numpy(a), "n": a[:, :1].copy()},
}


@pytest.mark.parametrize("leaf", list(LEAVES))
def test_microbatcher_results_match_inputs(make_batcher, leaf):
    """Six threads submit two rows each; every caller gets fn's rows of its
    own item back, numpy leaves, tensor leaves and trees alike."""
    calls = []

    def fn(batch):
        x = batch["x"] if isinstance(batch, dict) else batch
        calls.append(x.shape[0])
        n = batch["n"] if isinstance(batch, dict) else x[:, :1]
        return x * 2.0, x.sum(1), n

    mb = make_batcher(fn, max_batch=16, max_wait_ms=50)
    outs = _in_threads(lambda i: mb.submit(LEAVES[leaf](
        np.full((2, 4), float(i), np.float32))), list(range(6)))
    for i, (doubled, sums, n) in enumerate(outs):
        assert isinstance(doubled, np.ndarray)
        np.testing.assert_array_equal(doubled, np.full((2, 4), 2.0 * i))
        np.testing.assert_array_equal(sums, np.full(2, 4.0 * i))
        np.testing.assert_array_equal(n, np.full((2, 1), float(i)))
    assert 1 <= len(calls) <= 6 and sum(calls) >= 12


def test_microbatcher_shape_groups_run_separately(make_batcher):
    seen = []

    def fn(batch):
        seen.append(tuple(batch.shape[1:]))
        return batch + 1

    mb = make_batcher(fn, max_batch=8, max_wait_ms=100)
    a, b = _in_threads(lambda s: mb.submit(torch.zeros((1,) + s)),
                       [(3,), (5,)])
    assert a.shape == (1, 3) and b.shape == (1, 5)
    assert (a == 1).all() and (b == 1).all()
    assert sorted(seen) == [(3,), (5,)]


def test_microbatcher_error_reaches_every_waiter(make_batcher):
    """A batch that raises raises in each of its callers, and the batcher
    serves the next batch."""
    def fn(batch):
        if (batch < 0).any():
            raise ValueError("boom")
        return batch

    mb = make_batcher(fn, max_batch=8, max_wait_ms=100)
    outs = _in_threads(lambda v: mb.submit(np.full((1, 2), v, np.float32)),
                       [-1.0, 2.0, 3.0, 4.0])
    assert sum(isinstance(o, ValueError) for o in outs) >= 1
    assert isinstance(outs[0], ValueError)
    for o in outs[1:]:
        assert isinstance(o, ValueError) or o.shape == (1, 2)
    np.testing.assert_array_equal(mb.submit(np.ones((1, 2), np.float32)),
                                  np.ones((1, 2)))


@pytest.mark.parametrize("leaf", ["numpy", "tensor"])
def test_microbatcher_padding_is_invisible(make_batcher, leaf):
    seen = []

    def fn(batch):
        seen.append(batch.shape[0])
        return batch + 1

    mb = make_batcher(fn, max_batch=8, max_wait_ms=1, batch_ladder=(4, 8))
    out = mb.submit(LEAVES[leaf](np.zeros((3, 2), np.float32)))
    np.testing.assert_array_equal(out, np.ones((3, 2)))
    assert seen == [4]  # padded up the ladder


def test_microbatcher_stress(make_batcher):
    """More threads than cores and a short GIL switch interval: every caller
    gets its own rows back, and every submitted row ran exactly once."""
    ran = []

    def fn(batch):
        ran.append(int((batch[:, 0] > 0).sum()))
        return batch * 3.0

    mb = make_batcher(fn, max_batch=16, max_wait_ms=2)
    n = (os.cpu_count() or 4) + 4
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        outs = _in_threads(lambda i: mb.submit(np.full(
            (1 + i % 3, 2), i + 1.0, np.float32)), list(range(n)))
    finally:
        sys.setswitchinterval(before)
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out, np.full((1 + i % 3, 2),
                                                   3.0 * (i + 1)))
    assert sum(ran) == sum(1 + i % 3 for i in range(n))


class _Failing:
    """Stands in for a FusedClsRec whose multi-page passes fail."""

    def call_multi_scored(self, *args, **kw):
        raise RuntimeError("the multi-page pass failed")

    call_multi = call_multi_scored


def test_rec_batcher_error_reaches_every_waiter():
    """Two pages' chunks in one failing group: both callers get the error
    (no solo rerun), and the batcher's thread lives on."""
    rb = RecCropBatcher(max_wait_ms=200, batch_ladder=(4, 16))
    fused = _Failing()
    eye = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    valid = np.array([40, 60], np.int32)
    image = torch.zeros((64, 64, 3), dtype=torch.uint8)
    prob = torch.zeros((32, 32))
    try:
        outs = _in_threads(lambda _: rb.submit(
            fused, image, eye, valid, eye, eye, valid, 48, 320, False,
            promote=True, prob_dev=prob,
            pre_quads=np.zeros((2, 4, 2), np.float32),
            rhw=np.array([32, 32], np.int32)), [0, 1])
        assert all(isinstance(o, RuntimeError) for o in outs)
        assert rb._thread.is_alive()
    finally:
        _closed(rb)


# --------------------------------------------------------------- pieces
def quads(rng, n, h, w):
    """Seeded rotated quads (DB corner order), some past the edges."""
    out = []
    for _ in range(n):
        c = rng.uniform([-8, -8], [w + 8, h + 8])
        hw, hh, a = rng.uniform(2, 40), rng.uniform(2, 12), \
            rng.uniform(-0.6, 0.6)
        u = np.array([math.cos(a), math.sin(a)]) * hw
        v = np.array([-math.sin(a), math.cos(a)]) * hh
        out.append(np.stack([c - u - v, c + u - v, c + u + v, c - u + v]))
    return np.asarray(out, np.float32)


def prob_maps(rng, b, h, w):
    """Seeded float32 maps: bars of high probability over a low floor."""
    maps = rng.uniform(0.0, 0.3, (b, h, w))
    for m in maps:
        for _ in range(6):
            y, x = rng.integers(0, h - 8), rng.integers(0, w - 30)
            m[y:y + rng.integers(3, 8), x:x + rng.integers(8, 30)] = \
                rng.uniform(0.5, 1.0)
    return maps.astype(np.float32)


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_warp_crops_multi_matches_jax(interp):
    """Two seeded pages of one source bucket, crops of both interleaved
    (and rows of width 0): the port within 1e-4 of the JAX package, and
    each crop the one-page gather of its own page."""
    rng = np.random.default_rng(7)
    pages = rng.integers(0, 256, (2, 96, 128, 3), np.uint8)
    mats, valid = zip(*(warp.build_crop_matrix(q, 48, 320)
                        for q in quads(rng, 10, 96, 128)))
    mats = np.concatenate([np.stack(mats),
                           np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))])
    valid = np.array(list(valid) + [0, 0], np.int32)
    img_idx = rng.integers(0, 2, len(mats)).astype(np.int32)
    got = warp.warp_crops_multi(*map(torch.from_numpy, (
        pages, img_idx, mats, valid)), 48, 320, interp).numpy()
    want = np.asarray(jwarp.warp_crops_multi(*map(jnp.asarray, (
        pages, img_idx, mats, valid)), 48, 320, interp))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for p in (0, 1):
        sel = img_idx == p
        one = warp.warp_crops(torch.from_numpy(pages[p]),
                              torch.from_numpy(mats[sel]),
                              torch.from_numpy(valid[sel]), 48, 320, interp)
        np.testing.assert_array_equal(got[sel], one.numpy())
    assert np.abs(got[:10]).max() > 0.5


def test_quad_mask_mean_multi_matches_jax():
    """Three seeded maps with their own valid extents, quads scored each
    against its page: the port within 1e-5 of the JAX package and of the
    one-page scorer on its own page; zero quads score 0."""
    rng = np.random.default_rng(3)
    probs = prob_maps(rng, 3, 96, 160)
    rhw = np.array([[96, 160], [80, 120], [64, 144]], np.int32)
    q = quads(rng, 40, 96, 160)
    q[-4:] = 0.0
    img_idx = rng.integers(0, 3, len(q)).astype(np.int32)
    got = db_device.quad_mask_mean_multi(*map(torch.from_numpy, (
        probs, rhw, q, img_idx))).numpy()
    want = np.asarray(jdb_device.quad_mask_mean_multi(*map(jnp.asarray, (
        probs, rhw, q, img_idx))))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got[-4:] == 0).all() and (got > 0).sum() > 20
    for p, (rh, rw) in enumerate(rhw):
        sel = img_idx == p
        valid = (torch.arange(96)[:, None] < int(rh)) & \
            (torch.arange(160)[None, :] < int(rw))
        one = db_device.quad_mask_mean(torch.from_numpy(probs[p]),
                                       torch.from_numpy(q[sel]), valid)
        np.testing.assert_allclose(got[sel], one.numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------- the slice
@pytest.fixture(scope="module")
def dict_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("dict") / "ppocrv5_dict.txt"
    path.write_text("".join(f"<{i}>\n" for i in range(18383)))
    return str(path)


@pytest.fixture(scope="module")
def pages():
    return {n: read_bgr(str(HELDOUT / f"{n}.png")) for n in PAGES}


def _assert_same(got, ref):
    assert [l[1][0] for l in got] == [l[1][0] for l in ref]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert np.abs(np.asarray(g[0], np.float64) -
                      np.asarray(r[0], np.float64)).max() <= 2.0
        assert abs(float(g[1][1]) - float(r[1][1])) < 2e-3


@pytest.fixture(scope="module")
def slice_runs(dict_path, pages):
    """The pages through both packages' batched models, one thread a page
    on each side, once. The port's det waves (each wave's extents) and
    multi-page passes (pages, real pages, real rows, rows, width) are
    recorded on the way through."""
    kw = dict(BATCHED, rec_char_dict_path=dict_path)
    port, ref = ONNXPaddleOcr(device="cpu", **kw), JaxOcr(**kw)
    waves, groups = [], []
    det_fn = port.text_detector._page_batcher.batcher.fn
    port.text_detector._page_batcher.batcher.fn = \
        lambda batch: waves.append(batch["rhw"].copy()) or det_fn(batch)
    multi = port._fused.call_multi_scored

    def multi_spy(images, probs, rhw, img_idx, pre_quads, cls_mats,
                  cls_valid, rec_mats, rot_mats, rec_valid, out_h, out_w,
                  **kw):
        real = rec_valid > 0
        groups.append((images.shape[0], np.unique(img_idx[real]).size,
                       int(real.sum()), len(rec_valid), out_w))
        return multi(images, probs, rhw, img_idx, pre_quads, cls_mats,
                     cls_valid, rec_mats, rot_mats, rec_valid, out_h, out_w,
                     **kw)

    port._fused.call_multi_scored = multi_spy
    try:
        got = _in_threads(lambda n: port.ocr(pages[n])[0], PAGES)
        want = _in_threads(lambda n: ref.ocr(pages[n])[0], PAGES)
        yield {"port": port, "ref": ref, "got": dict(zip(PAGES, got)),
               "want": dict(zip(PAGES, want)), "waves": waves,
               "groups": groups}
    finally:
        _closed(port.text_detector._page_batcher,
                port.text_recognizer._crop_batcher,
                ref.text_detector._page_batcher,
                ref.text_recognizer._crop_batcher)


@pytest.mark.parametrize("page", PAGES)
def test_batched_slice_matches_jax(slice_runs, page):
    """Each page, from its own thread, through the port's batchers against
    the JAX package's: texts, boxes and scores agree. Coalesced and solo
    groups compute the same rows, so the JAX side is compared whatever
    groups its timing formed."""
    got, want = slice_runs["got"][page], slice_runs["want"][page]
    assert not isinstance(got, BaseException), got
    assert not isinstance(want, BaseException), want
    assert len(want) > 4
    _assert_same(got, want)


def test_port_coalesced_across_requests(slice_runs):
    """The port's side really shared device calls: a det wave held two
    pages or more, padded up (1, 2, 4, 8) with pages of extent 0, and a
    multi-page pass held two pages' rows at the canonical 64 rows."""
    waves, groups = slice_runs["waves"], slice_runs["groups"]
    print("det waves (real pages / wave):",
          [(int((w[:, 0] > 0).sum()), len(w)) for w in waves],
          "rec groups (pages, real pages, real rows, rows, width):", groups)
    assert all(len(w) in (1, 2, 4, 8) for w in waves)
    assert sum(int((w[:, 0] > 0).sum()) for w in waves) == len(PAGES)
    assert max(int((w[:, 0] > 0).sum()) for w in waves) >= 2
    multi = [g for g in groups if g[1] >= 2]
    assert multi and all(g[3] == 64 and g[4] in (640, 960) for g in multi)


def test_batched_equals_unbatched_gather(slice_runs, dict_path, pages):
    """The port's batched results are its own unbatched results at the
    gather warp (the form every batcher run takes): per-page canvas vs the
    fixed canvas, solo vs coalesced passes."""
    plain = ONNXPaddleOcr(device="cpu", rec_char_dict_path=dict_path,
                          tpu_warp_stage="off", **SMALL)
    for name in PAGES:
        _assert_same(slice_runs["got"][name], plain.ocr(pages[name])[0])


def test_failed_wave_reaches_every_caller(slice_runs, pages, monkeypatch):
    """A det wave that fails raises in each page's ocr(); nothing runs the
    page another way (no unbatched det forward)."""
    port = slice_runs["port"]
    det = port.text_detector
    unbatched = []
    monkeypatch.setattr(det, "bitmap_forward",
                        lambda *a, **kw: unbatched.append(1))

    def fail(batch):
        raise RuntimeError("det wave failed")

    monkeypatch.setattr(det._page_batcher.batcher, "fn", fail)
    outs = _in_threads(lambda n: port.ocr(pages[n]), PAGES[:2])
    assert all(isinstance(o, RuntimeError) for o in outs) and not unbatched


def test_batched_det_matches_one_page_and_jax(slice_runs, pages):
    """The det batcher's wave on three canvases with distinct extents and
    a padding page of extent 0: each map equals the port's one-page forward
    on its canvas within 1e-5, the padding page sets no bit, and the bits
    equal the JAX package's batched bits but for ties (|p − thresh| < 1e-5
    in the JAX map), as test_bitmaps_match_jax."""
    port, ref = slice_runs["port"], slice_runs["ref"]
    det = port.text_detector
    cap_h, cap_w = det._page_batcher.canvas
    extents = [(320, 256), (224, 320), (288, 288)]
    xs = []
    for (rh, rw), name in zip(extents, PAGES):
        image, h, w = resize_dev.put_src_bucket(pages[name], "cpu")
        xs.append(resize_dev.resize_normalize_det(image, h, w, rh, rw,
                                                  cap_h, cap_w))
    xs.append(torch.zeros_like(xs[0]))
    rhw = np.array(extents + [(0, 0)], np.int32)
    bits, probs = det.pages_bits({"pages": torch.stack(xs), "rhw": rhw})
    assert bits.shape == (4, cap_h, cap_w // 8)
    assert not bits[3].any()
    for i, (rh, rw) in enumerate(extents):
        np.testing.assert_allclose(probs[i].numpy(),
                                   det.forward(xs[i], rh, rw).numpy(),
                                   rtol=0, atol=1e-5)
    thresh = det.postprocess_op.thresh
    jbits, jprobs = ref.text_detector.forward.make_pages_bits_fn(thresh)(
        {"pages": jnp.asarray(torch.stack(xs).numpy()),
         "rhw": jnp.asarray(rhw)})
    jbits, jprobs = np.asarray(jbits), np.asarray(jprobs)
    assert jbits.shape == tuple(bits.shape)
    for i, (rh, rw) in enumerate(extents):
        got = det_pre.unpack_bitmap(bits[i].numpy()[:rh, :rw // 8], rw)
        want = det_pre.unpack_bitmap(jbits[i][:rh, :rw // 8], rw)
        diff = got != want
        print(f"wave row {i} {rh}x{rw}: {int(diff.sum())} pixels differ, "
              f"{int(want.sum())} set")
        assert (np.abs(jprobs[i][:rh, :rw][diff] - thresh) < 1e-5).all()
        assert diff.sum() <= 1e-4 * diff.size and want.sum() > 100
        np.testing.assert_allclose(probs[i].numpy()[:rh, :rw],
                                   jprobs[i][:rh, :rw], rtol=0, atol=1e-4)


# --------------------------------------------------- the multi-page steps
def _multi_inputs(slice_runs, pages, cls_shape, rows=6, bsz=16, out_w=320):
    """Two pages' stack and `rows` boxes of each from the batched runs, as
    the rec batcher packs them: (images (2, H, W, 3) uint8, img_idx,
    (cls_mats, cls_valid, rec_mats, rot_mats, rec_valid), pre_quads), rows
    past the real ones the identity with width 0 and zero quads."""
    eye = np.eye(3, dtype=np.float32)
    images, idx, mats, quads_ = [], [], [], []
    for p, name in enumerate(PAGES[:2]):
        image, _, _ = resize_dev.put_src_bucket(pages[name], "cpu")
        images.append(image)
        for box in slice_runs["got"][name][:rows]:
            box = np.asarray(box[0], np.float32)
            rec, rec_w = warp.build_crop_matrix(box, 48, out_w)
            rot, _ = warp.build_crop_matrix(box, 48, out_w, rotate180=True)
            cls, cls_w = warp.build_crop_matrix(box, *cls_shape)
            mats.append((cls, cls_w, rec, rot, rec_w))
            idx.append(p)
            quads_.append(box / 3.2)
    n = len(mats)
    mats += [(eye, 0, eye, eye, 0)] * (bsz - n)
    cls, cls_w, rec, rot, rec_w = (np.asarray(c) for c in zip(*mats))
    out = (np.stack(cls).astype(np.float32), cls_w.astype(np.int32),
           np.stack(rec).astype(np.float32), np.stack(rot).astype(np.float32),
           rec_w.astype(np.int32))
    img_idx = np.array(idx + [0] * (bsz - n), np.int32)
    pre = np.concatenate([np.asarray(quads_, np.float32),
                          np.zeros((bsz - n, 4, 2), np.float32)])
    return torch.stack(images), img_idx, out, pre, n


def _tie_steps(fused, images, img_idx, mats, out_w, use_cls):
    """(N, T) bool: the steps whose top two logits (the port's features,
    the head in float64) lie within 1e-5 relative of each other; and the
    number of rows the port's classifier turned."""
    cls_mats, cls_valid, rec_mats, rot_mats, rec_valid = \
        map(torch.from_numpy, mats)
    img_idx = torch.from_numpy(img_idx)

    def crops(m, v, h, w):
        return warp.warp_crops_multi(images, img_idx, m, v, h, w,
                                     fused.warp_form["interp"])

    with torch.inference_mode():
        rot = torch.zeros(len(rec_mats), dtype=torch.bool)
        if use_cls:
            rec_mats, _, rot = fused._select(crops, cls_mats, cls_valid,
                                             rec_mats, rot_mats)
        model = fused.rec_forward.model
        feats = model.features(crops(rec_mats, rec_valid, 48, out_w)
                               .permute(0, 3, 1, 2), (rec_valid + 7) // 8)
        logits = feats.double() @ model.head.w.double() + \
            model.head.b.double()
        top = torch.topk(logits, 2, dim=-1).values
    tie = (top[..., 0] - top[..., 1]).abs() <= 1e-5 * top[..., 0].abs()
    return tie.numpy(), int(rot.sum())


@pytest.fixture(scope="module")
def flip_pair(dict_path):
    kw = dict(FLIP, rec_char_dict_path=dict_path, **SMALL)
    with pytest.warns(UserWarning, match="randomly initialized"):
        return ONNXPaddleOcr(device="cpu", **kw), JaxOcr(**kw)


@pytest.mark.parametrize("step", ["call_multi", "call_multi_scored"])
def test_multi_steps_match_jax(slice_runs, flip_pair, pages, step):
    """The fused multi-page steps on the same two pages, rows and maps on
    both sides: call_multi with the classifier turning crops,
    call_multi_scored (the bitmap wire's) without it. idx equal over each
    row's valid steps outside top-2 ties, prob within 2e-3, scores within
    1e-5."""
    port, ref = flip_pair if step == "call_multi" else \
        (slice_runs["port"], slice_runs["ref"])
    use_cls = step == "call_multi"
    pf, jf = port._fused, ref._fused
    images, img_idx, mats, pre, n = _multi_inputs(
        slice_runs, pages, (pf.cls_h, pf.cls_w))
    if use_cls:
        got = pf.call_multi(images, img_idx, *mats, 48, 320, use_cls=True)
        want = jf.call_multi(images.numpy(), img_idx, *mats, 48, 320,
                             use_cls=True)
    else:
        probs = prob_maps(np.random.default_rng(5), 2, 320, 320)
        rhw = np.array([[224, 288], [256, 320]], np.int32)
        got = pf.call_multi_scored(images, torch.from_numpy(probs), rhw,
                                   img_idx, pre, *mats, 48, 320,
                                   use_cls=False)
        want = jf.call_multi_scored(images.numpy(), jnp.asarray(probs), rhw,
                                    img_idx, pre, *mats, 48, 320,
                                    use_cls=False)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    T = 320 // 8
    tie, n_rot = _tie_steps(pf, images, img_idx, mats, 320, use_cls)
    for r in range(n):
        vt = min(T, -(-int(mats[-1][r]) // 8))
        ok = (got[r, :vt] == want[r, :vt]) | tie[r, :vt]
        assert ok.all(), f"row {r}: idx differs outside ties"
        np.testing.assert_allclose(got[r, T:T + vt], want[r, T:T + vt],
                                   rtol=0, atol=2e-3)
    if use_cls:
        assert got.shape[1] == 2 * T and n_rot > 0
    else:
        assert got.shape[1] == 2 * T + 1
        np.testing.assert_allclose(got[:, 2 * T], want[:, 2 * T], rtol=0,
                                   atol=1e-5)
        assert (got[:n, 2 * T] > 0).all() and (got[n:, 2 * T] == 0).all()


# --------------------------------------------------------- settings
def test_batched_model_is_cuda_unless_asked(dict_path, monkeypatch):
    """Both flags construct on the CPU when asked for; by default the model
    wants CUDA and raises without it, as every entry point of the port."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(rec_char_dict_path=dict_path, tpu_det_microbatch=True,
              tpu_rec_microbatch=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        ONNXPaddleOcr(**kw)
    model = ONNXPaddleOcr(device="cpu", **kw)
    try:
        assert model.route == "bitmap"
        assert model.text_detector._page_batcher.canvas == (960, 960)
        assert model.text_recognizer._crop_batcher.batch_ladder == (4, 16,
                                                                    64)
    finally:
        _closed(model.text_detector._page_batcher,
                model.text_recognizer._crop_batcher)


@pytest.mark.parametrize("extra,mode", [
    (dict(tpu_det_microbatch=True, tpu_det_batch_input="host"), "bits"),
    (dict(tpu_det_microbatch=True, tpu_det_wire="map"), "maps"),
    (dict(tpu_det_microbatch=True, tpu_det_postprocess="device"), "boxes"),
    (dict(tpu_pipeline="onecall", tpu_onecall_wave=True), None),
], ids=["batch_input_host", "maps_wire", "boxes_mode", "onecall_wave"])
def test_modes_needing_the_host_resize_raise(dict_path, extra, mode):
    """The batcher modes that need the host det resize, and the one-call
    wave coalescer, which this test once found refused, build now (the
    name is kept): the det batcher in its mode or the coalescer, and
    close() stops every thread they started."""
    before = threading.active_count()
    model = ONNXPaddleOcr(device="cpu", rec_char_dict_path=dict_path,
                          **extra)
    batcher = model.text_detector._page_batcher
    if mode is None:
        assert batcher is None and model._onecall._wave is not None
    else:
        assert batcher.mode == mode
    assert threading.active_count() > before
    model.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before
