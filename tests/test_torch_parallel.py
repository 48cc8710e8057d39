"""Serving across devices (onnxocr_tpu_torch/parallel/serving.py, the
mesh helpers of parallel/mesh.py, OneCallPipeline.sharded_batch_fn, the det
page batcher on a mesh) against the JAX package on the CPU.

The JAX side runs on tests/conftest.py's 8 virtual CPU devices, as
tests/test_parallel.py does; the port's on grids of 'cpu' repeated, 8 × 1
and 4 × 2 (the rows of a 4 × 2 grid each take two pages; along a row's
model axis the port runs once, as the JAX program computes the same thing
on each device of the row). Tolerances:

* ShardedDetBatch (DBNet init at seed 0, 5 seeded pages of 64², mixed
  extents): the maps within 2e-5 of JAX's ShardedDetBatch and of the
  port's unsharded DBNet on the same 5 pages. That is float rounding: on
  these pages the sharded maps differ from JAX's by 1.1e-5 at most and
  from the port's own DBNet at batch 5 by 8.5e-6 (the CPU convolutions
  round differently at another batch size); tests/test_torch_models.py
  holds the DBNet against JAX's at 1e-4.
* ShardedRecBatch (SVTR at vocab 64, 6 seeded crops 48 × 64): idx equal,
  prob within 1e-5.
* The det batcher on a mesh: maps mode, the ladder in multiples of the data
  axis, 4 concurrent pages equal to each other and, decoded, within 1/255
  (one uint8 quantum) of JAX's batcher on its 8-device mesh.
* sharded_batch_fn at tests/test_parallel.py's configuration (untrained
  cls, K_rec 8, rec width 96, 64² canvas) on 8 seeded pages: per page the
  n_valid and valid rows of JAX's packed buffer, quads within 1e-3, texts
  equal and scores within 2e-3 (the one-call tests' tolerances); every
  page's block equals the port's single `step_wave` of that page.
"""
import concurrent.futures
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from onnxocr_tpu import ONNXPaddleOcr as JaxOcr
from onnxocr_tpu.models import dbnet as jdbnet, svtr as jsvtr
from onnxocr_tpu.parallel import mesh as jmesh, serving as jserving
from onnxocr_tpu.pipeline import backends as jbackends
from onnxocr_tpu.runtime.batcher import DetPageBatcher as JaxDetPageBatcher

from test_onnx_executor import _make_conv_model

from onnxocr_tpu_torch import ONNXPaddleOcr
from onnxocr_tpu_torch.models import convert
from onnxocr_tpu_torch.onnx import ir
from onnxocr_tpu_torch.onnx.executor import GraphExecutor
from onnxocr_tpu_torch.ops import det_pre
from onnxocr_tpu_torch.parallel import mesh, serving

GRIDS = {"8x1": 1, "4x2": 2}
ONECALL = dict(use_angle_cls=True, tpu_pipeline="onecall",
               det_limit_side_len=64, tpu_det_bucket=64,
               tpu_onecall_rec_width=96, tpu_onecall_max_boxes=8,
               tpu_onecall_det_candidates=32, tpu_allow_untrained=True)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Test processes run side by side on the machine's cores: two torch
    threads keep this module from oversubscribing them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jmesh.make_mesh(8, model_parallel=1)


def grid(name):
    return mesh.make_mesh(8, model_parallel=GRIDS[name], devices=["cpu"] * 8)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def dbnet_pair():
    params = jdbnet.init(0)
    return params, convert.build_dbnet(_np(params), "cpu")


@pytest.fixture(scope="module")
def dict_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("dict") / "ppocrv5_dict.txt"
    path.write_text("".join(f"<{i}>\n" for i in range(18383)))
    return str(path)


def _pages(n, hw, seed):
    """n white pages with dark bars at seeded places."""
    rng = np.random.default_rng(seed)
    pages = np.full((n,) + hw + (3,), 255, np.uint8)
    for p in pages:
        for _ in range(2):
            y = int(rng.integers(4, hw[0] - 14))
            x = int(rng.integers(2, hw[1] // 3))
            p[y:y + int(rng.integers(8, 12)),
              x:x + int(rng.integers(16, hw[1] - x - 2))] = \
                rng.integers(0, 60)
    return pages


@pytest.mark.parametrize("name", GRIDS)
def test_sharded_det_batch_matches_jax(dbnet_pair, mesh8, name):
    params, model = dbnet_pair
    rng = np.random.default_rng(0)
    pages = rng.integers(0, 256, (5, 64, 64, 3), dtype=np.uint8)
    rhw = np.array([[64, 64], [32, 64], [64, 40], [20, 24], [48, 48]],
                   np.int32)
    want = np.asarray(jserving.ShardedDetBatch(params, mesh8)(pages, rhw))
    det = serving.ShardedDetBatch(model, grid(name))
    got = det(pages, rhw)
    assert got.shape == (5, 64, 64) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 2e-5
    with torch.inference_mode():
        x = det_pre.normalize_det(torch.from_numpy(pages))
        ext = torch.from_numpy(rhw)
        plain = model(x.permute(0, 3, 1, 2), valid_hw=(ext[:, 0],
                                                       ext[:, 1]))
    assert (got - plain).abs().max() <= 2e-5
    # the default extent is the full canvas, as in JAX
    np.testing.assert_allclose(
        det(pages[:3]).numpy(),
        np.asarray(jserving.ShardedDetBatch(params, mesh8)(pages[:3])),
        atol=2e-5, rtol=0)
    det.close()


@pytest.mark.parametrize("name", GRIDS)
def test_sharded_rec_batch_matches_jax(mesh8, name):
    params = jsvtr.init(0, vocab_size=64)
    model = convert.build_svtr(_np(params), "cpu")
    crops = np.random.default_rng(1).uniform(
        -1, 1, (6, 48, 64, 3)).astype(np.float32)
    want_idx, want_prob = jserving.ShardedRecBatch(params, mesh8)(crops)
    idx, prob = serving.ShardedRecBatch(model, grid(name))(crops)
    assert idx.shape == prob.shape == (6, 8) and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert np.abs(prob.numpy() - np.asarray(want_prob)).max() <= 1e-5


@pytest.mark.parametrize("name", GRIDS)
def test_det_page_batcher_on_mesh_matches_jax(dbnet_pair, mesh8, dict_path,
                                              name):
    """The maps wave on a mesh: ladder in data-axis multiples, 4
    concurrent pages alike and equal to the JAX package's batcher on its
    mesh (both decode a uint8 wire)."""
    params, model = dbnet_pair
    port = ONNXPaddleOcr(device="cpu", det_limit_side_len=64,
                         tpu_det_map_dtype="uint8",
                         rec_char_dict_path=dict_path)
    det = port.text_detector
    det.model = model
    m = grid(name)
    assert det.enable_page_batching(max_wait_ms=20.0, mesh=m)
    pb = det._page_batcher
    n_data = m.shape["data"]
    assert pb.mode == "maps" and pb.mesh is m and port.route == "map"
    assert pb.batcher.batch_ladder == tuple(sorted(
        {max(n_data, -(-b // n_data) * n_data) for b in (1, 2, 4, 8)}))
    assert all(b % n_data == 0 for b in pb.batcher.batch_ladder)
    fwd = jbackends.DetForward("native", params=params, map_dtype="uint8")
    jpb = JaxDetPageBatcher(fwd, limit_side_len=64, max_wait_ms=20.0,
                            batch_ladder=(1, 2, 4, 8), mesh=mesh8)
    img = np.full((50, 70, 3), 255, np.uint8)
    img[10:30, 5:60] = 20
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(pb.submit, [img] * 4))
        want = list(pool.map(jpb.submit, [img] * 4))
    try:
        ref, ref_info = outs[0]
        assert ref.dtype == np.uint8 and ref.shape == want[0][0].shape
        for prob, info in outs:
            np.testing.assert_array_equal(prob, ref)
            np.testing.assert_allclose(info, ref_info)
        np.testing.assert_allclose(det.decode_map(ref), want[0][0],
                                   atol=1 / 255 + 1e-6, rtol=0)
        np.testing.assert_allclose(ref_info, want[0][1])
    finally:
        port.close()
        jpb.close()


@pytest.fixture(scope="module")
def onecall_pair(dict_path):
    kw = dict(ONECALL, rec_char_dict_path=dict_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (ONNXPaddleOcr(device="cpu", **kw),
                JaxOcr(use_gpu=False, **kw))


@pytest.fixture(scope="module")
def onecall_pages():
    return _pages(8, (64, 64), seed=2)


@pytest.fixture(scope="module")
def jax_packed(onecall_pair, onecall_pages, mesh8):
    joc = onecall_pair[1]._onecall
    dims = np.full((8,), 64, np.int32)
    fn = joc.sharded_batch_fn(True, mesh8, out_h=64, out_w=64)
    return np.asarray(fn(*joc._params(True), onecall_pages, dims, dims,
                         dims, dims))


def _texts_scores(res):
    return [r[0] for r in res], np.asarray([r[1] for r in res])


@pytest.mark.parametrize("name", GRIDS)
def test_sharded_batch_fn_matches_jax(onecall_pair, onecall_pages,
                                      jax_packed, name):
    port, ref = onecall_pair
    oc, joc = port._onecall, ref._onecall
    dims = np.full((8,), 64, np.int32)
    fn = oc.sharded_batch_fn(True, grid(name), out_h=64, out_w=64)
    out = fn(onecall_pages, dims, dims, dims, dims).numpy()
    assert out.shape == jax_packed.shape
    k = oc.k_rec
    lines = 0
    for b, page in enumerate(onecall_pages):
        want = jax_packed[b]
        valid = out[b, :k, 9] > 0.5
        assert out[b, k, 0] == want[k, 0] >= 1
        np.testing.assert_array_equal(valid, want[:k, 9] > 0.5)
        np.testing.assert_allclose(out[b, :k, :8][valid],
                                   want[:k, :8][valid], rtol=0, atol=1e-3)
        image = torch.from_numpy(page)
        _, got = oc.decode_packed(out[b], image, True)
        _, exp = joc._decode_packed(want, jnp.asarray(page), True)
        (gt, gs), (wt, ws) = _texts_scores(got), _texts_scores(exp)
        assert gt == wt
        assert np.abs(gs - ws).max() < 2e-3
        lines += len(gt)
        single = oc.step_wave(image[None], [64], [64], [64], [64], 64, 64,
                              0, 0, True).numpy()[0]
        np.testing.assert_allclose(out[b], single, rtol=0, atol=1e-6)
    assert lines >= 8
    # the canvas defaults to round_up(limit, bucket), 64 here
    fn0 = oc.sharded_batch_fn(True, grid(name))
    np.testing.assert_array_equal(
        fn0(onecall_pages, dims, dims, dims, dims).numpy(), out)
    with pytest.raises(ValueError):
        fn(onecall_pages[:5], dims[:5], dims[:5], dims[:5], dims[:5])
    fn.rows.close()
    fn0.rows.close()


def test_page_batching_mesh_rules(dict_path):
    """A graph det and the boxes mode drop the mesh, as in the JAX
    package; with the mesh the bitmap route becomes the map route."""
    m = grid("8x1")
    port = ONNXPaddleOcr(device="cpu", rec_char_dict_path=dict_path)
    det = port.text_detector
    try:
        assert port.route == "bitmap"
        det.backend = "graph"
        assert det.enable_page_batching(mesh=m)
        assert det._page_batcher.mode == "bits" and \
            det._page_batcher.mesh is None and port.route == "bitmap"
        det.backend = "native"
        assert det.enable_page_batching(mesh=m)
        assert det._page_batcher.mode == "maps" and port.route == "map"
    finally:
        port.close()
    boxes = ONNXPaddleOcr(device="cpu", tpu_det_postprocess="device",
                          rec_char_dict_path=dict_path)
    try:
        assert boxes.text_detector.enable_page_batching(mesh=m)
        pb = boxes.text_detector._page_batcher
        assert pb.mode == "boxes" and pb.mesh is None
        assert pb.batcher.batch_ladder == (1, 2, 4, 8)
        assert boxes.route == "device"
    finally:
        boxes.close()


def test_svtr_replica_carries_w_split():
    """mesh.replicate deep-copies and moves a module with its
    non-persistent buffers: each row's SVTR holds its own w_split, on the
    row's device, and runs the head. (On the card, chip_smoke.py's phase M
    runs kernel 1 on every row's replica.)"""
    model = convert.build_svtr(_np(jsvtr.init(0, vocab_size=64)), "cpu")
    m = mesh.make_mesh(2, devices=["cpu", "cpu"])
    reps = mesh.replicate(model, m)
    assert len(reps) == 2 and reps[1] is not model
    for rep, dev in zip(reps, mesh.row_devices(m)):
        w = rep.head.w_split
        assert w is not None and w.device == dev
        assert w.data_ptr() != model.head.w_split.data_ptr()
        torch.testing.assert_close(w, model.head.w_split, rtol=0, atol=0)
    crops = torch.zeros((2, 3, 48, 64))
    with torch.inference_mode():
        torch.testing.assert_close(reps[1](crops), model(crops))


def test_graph_executor_replicas():
    """A graph stage (not an nn.Module) replicates through its executor's
    `.to`: each row's copy runs on the row's device with its own upload
    cache and gives the executor's outputs."""
    blob, _ = _make_conv_model()
    ex = GraphExecutor(ir.parse_model(blob), name="t", device="cpu")
    reps = mesh.replicate(ex, mesh.make_mesh(2, devices=["cpu"] * 2))
    x = np.random.default_rng(3).random((1, 3, 8, 8)).astype(np.float32)
    want = ex({"x": x})[0]
    assert ex.device_weights
    for rep in reps:
        assert rep is not ex and rep.device == torch.device("cpu")
        assert rep._uploads is not ex._uploads
        assert rep.device_weights.keys() == ex.device_weights.keys()
        torch.testing.assert_close(rep({"x": x})[0], want, rtol=0, atol=0)


def test_a_failing_row_reaches_the_caller():
    rows = mesh.Rows(mesh.make_mesh(4, devices=["cpu"] * 4))
    done = []

    def fn(i, part):
        if i == 2:
            raise RuntimeError("row 2 failed")
        done.append(i)
        return torch.as_tensor(part)

    with pytest.raises(RuntimeError, match="row 2"):
        rows.split(fn, (np.arange(8),))
    assert sorted(done) == [0, 1, 3]
    # padding rows are sliced off, the order is the batch's
    out = rows.split(lambda i, part: torch.as_tensor(part) * 10,
                     (np.arange(6),))
    assert out.tolist() == [0, 10, 20, 30, 40, 50]
    rows.close()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "behaviour: without CUDA nothing runs on a CUDA mesh")
def test_cuda_entry_points_raise_without_cuda(dbnet_pair, onecall_pair):
    cuda = mesh.Mesh(np.array([["cuda:0"]], object))
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.ShardedDetBatch(dbnet_pair[1], cuda)
    model = convert.build_svtr(_np(jsvtr.init(0, vocab_size=64)), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.ShardedRecBatch(model, cuda)
    with pytest.raises(RuntimeError, match="CUDA"):
        onecall_pair[0]._onecall.sharded_batch_fn(True, cuda)
