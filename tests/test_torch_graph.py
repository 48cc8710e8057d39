"""Backend resolution in the port vs the JAX package on the CPU: the ONNX
graph executor, `lift_cls`, the untrained det / rec init and the flag
table.

From the bottom up: every case of tests/test_onnx_ops.py, the tiny conv of
tests/test_onnx_executor.py and more ops (Pad in its three modes, Cast,
Split, Gather on shapes, LayerNorm written out as a graph, Erf and GELU,
ConvTranspose with output_padding, ...) run through both executors on the
same tests/onnx_builder.py graph and seeded inputs (rtol 1e-5, atol
1e-5); BatchNorm folding; the exported det / rec / cls graphs
(chip_smoke.export_graph) against the JAX executor and the port's own
native model on the same tree (1e-4); `lift_cls` and the seeded inits
(exact); the backend each package picks for every (stage, tpu_backend,
file) case; and the slice: the graph det / rec of tests/test_graph_e2e.py
through `ONNXPaddleOcr` of both packages on its bar page, with the
stand-in dictionary passed to both (texts equal, boxes within 2 px,
scores within 2e-3).
"""
import os
import warnings

import numpy as np
import pytest
import torch

from onnxocr_tpu import ONNXPaddleOcr as JaxOcr
from onnxocr_tpu import config as jconfig
from onnxocr_tpu.models import crnn as jcrnn
from onnxocr_tpu.models import dbnet as jdbnet
from onnxocr_tpu.models import lift as jlift
from onnxocr_tpu.models import svtr as jsvtr
from onnxocr_tpu.onnx import ir as jir
from onnxocr_tpu.onnx import ops as jops
from onnxocr_tpu.onnx.executor import GraphExecutor as JaxExecutor
from onnxocr_tpu.pipeline import backends as jbackends

import chip_smoke
from onnx_builder import build_model, node_bytes
from test_graph_e2e import BARS, _bar_page, _write_det_onnx, _write_rec_onnx
from test_onnx_executor import _make_conv_model

from onnxocr_tpu_torch import ONNXPaddleOcr, config
from onnxocr_tpu_torch.models import cls as cls_model
from onnxocr_tpu_torch.models import convert, crnn, dbnet, lift, svtr
from onnxocr_tpu_torch.onnx import ir, ops
from onnxocr_tpu_torch.onnx.executor import GraphExecutor
from onnxocr_tpu_torch.pipeline import backends


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Test processes run side by side on the machine's cores: two torch
    threads keep this module from oversubscribing them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _both(blob, feeds, optimize=True):
    """The graph `blob` through the JAX executor and the port's (on the
    CPU) → (JAX outputs, port outputs) as numpy arrays."""
    ref = JaxExecutor(jir.parse_model(blob), name="t", optimize=optimize)
    port = GraphExecutor(ir.parse_model(blob), name="t", optimize=optimize,
                         device="cpu")
    return ([np.asarray(o) for o in ref(feeds)],
            [o.numpy() for o in port(feeds)])


# ------------------------------------------------------------- op cases
def _rng(seed):
    return np.random.default_rng(seed)


def _f(seed, *shape):
    return _rng(seed).normal(size=shape).astype(np.float32)


def _i64(*v):
    return np.array(v, np.int64)


def _lstm_case():
    T, N, I, H = 7, 2, 5, 4
    r = _rng(3)
    return ([node_bytes("LSTM", ["x", "W", "R", "B"], ["Y", "Yh", "Yc"],
                        {"direction": "bidirectional", "hidden_size": H})],
            {"x": _f(0, T, N, I)}, ["x"], ["Y", "Yh", "Yc"],
            {"W": r.normal(size=(2, 4 * H, I)).astype(np.float32),
             "R": r.normal(size=(2, 4 * H, H)).astype(np.float32),
             "B": r.normal(size=(2, 8 * H)).astype(np.float32)})


def _layer_norm_graph():
    """LayerNorm written out op by op (paddle2onnx, opset 11)."""
    nodes = [node_bytes("ReduceMean", ["x"], ["m"], {"axes": [-1]}),
             node_bytes("Sub", ["x", "m"], ["d"]),
             node_bytes("Pow", ["d", "two"], ["d2"]),
             node_bytes("ReduceMean", ["d2"], ["v"], {"axes": [-1]}),
             node_bytes("Add", ["v", "eps"], ["ve"]),
             node_bytes("Sqrt", ["ve"], ["s"]),
             node_bytes("Div", ["d", "s"], ["n"]),
             node_bytes("Mul", ["n", "g"], ["ng"]),
             node_bytes("Add", ["ng", "b"], ["y"])]
    return (nodes, {"x": _f(1, 2, 5, 8)}, ["x"], ["y"],
            {"two": np.float32(2.0).reshape(()),
             "eps": np.float32(1e-6).reshape(()),
             "g": _f(2, 8), "b": _f(3, 8)})


def _gelu_graph():
    """Erf GELU: 0.5 x (1 + erf(x / sqrt 2)); and the tanh form."""
    c = lambda v: np.float32(v).reshape(())  # noqa: E731
    nodes = [node_bytes("Div", ["x", "r2"], ["a"]),
             node_bytes("Erf", ["a"], ["e"]),
             node_bytes("Add", ["e", "one"], ["e1"]),
             node_bytes("Mul", ["x", "e1"], ["xe"]),
             node_bytes("Mul", ["xe", "half"], ["y"]),
             node_bytes("Gelu", ["x"], ["z"], {"approximate": "tanh"})]
    return (nodes, {"x": _f(4, 3, 7)}, ["x"], ["y", "z"],
            {"r2": c(np.sqrt(2.0)), "one": c(1.0), "half": c(0.5)})


def _case(op, inputs, feeds, inits=None, attrs=None, outputs=("y",),
          opset=11):
    return ([node_bytes(op, list(inputs), list(outputs), attrs)], feeds,
            [k for k in inputs if k in feeds], list(outputs), inits or {},
            opset)


OP_CASES = {
    # tests/test_onnx_ops.py
    "maxpool_ceil_mode": _case(
        "MaxPool", ["x"], {"x": np.arange(25, dtype=np.float32)
                           .reshape(1, 1, 5, 5)},
        attrs={"kernel_shape": [2, 2], "strides": [2, 2], "ceil_mode": 1}),
    "averagepool_pads_exclude": _case(
        "AveragePool", ["x"], {"x": np.ones((1, 1, 4, 4), np.float32)},
        attrs={"kernel_shape": [3, 3], "strides": [1, 1],
               "pads": [1, 1, 1, 1]}),
    "conv_transpose_2x": _case(
        "ConvTranspose", ["x", "w"], {"x": _f(0, 1, 3, 6, 7)},
        {"w": _f(1, 3, 5, 2, 2)},
        {"strides": [2, 2], "kernel_shape": [2, 2]}),
    "resize_nearest_asymmetric": _case(
        "Resize", ["x", "roi", "scales"],
        {"x": np.arange(4, dtype=np.float32).reshape(1, 1, 2, 2)},
        {"roi": np.zeros(0, np.float32),
         "scales": np.array([1, 1, 2, 2], np.float32)},
        {"mode": "nearest", "coordinate_transformation_mode": "asymmetric",
         "nearest_mode": "floor"}),
    "resize_linear_half_pixel": _case(
        "Resize", ["x", "roi", "scales"],
        {"x": _rng(0).random((1, 1, 8, 10)).astype(np.float32)},
        {"roi": np.zeros(0, np.float32),
         "scales": np.array([1, 1, 2, 2], np.float32)},
        {"mode": "linear", "coordinate_transformation_mode": "half_pixel"}),
    "slice_negative_step": _case(
        "Slice", ["x", "st", "en", "ax", "sp"],
        {"x": np.arange(10, dtype=np.float32).reshape(1, 10)},
        {"st": _i64(9), "en": _i64(-11), "ax": _i64(1), "sp": _i64(-1)}),
    "lstm_bidirectional": _lstm_case() + (11,),
    "gemm_transB_bias": _case(
        "Gemm", ["a", "w", "b"], {"a": _f(0, 3, 4)},
        {"w": _f(1, 5, 4), "b": _f(2, 5)}, {"transB": 1}),
    "shape_arithmetic_reshape_static": ([
        node_bytes("Shape", ["x"], ["s"]),
        node_bytes("Gather", ["s", "zero"], ["n"], {"axis": 0}),
        node_bytes("Unsqueeze", ["n"], ["n1"], {"axes": [0]}),
        node_bytes("Concat", ["n1", "minus1"], ["tgt"], {"axis": 0}),
        node_bytes("Reshape", ["x", "tgt"], ["y"])],
        {"x": _rng(0).random((2, 3, 4)).astype(np.float32)}, ["x"], ["y"],
        {"zero": np.array(0, np.int64), "minus1": _i64(-1)}, 11),
    "hardsigmoid": _case(
        "HardSigmoid", ["x"],
        {"x": np.linspace(-4, 4, 9, dtype=np.float32).reshape(1, 9)},
        attrs={"alpha": 1.0 / 6.0, "beta": 0.5}),
    "hardswish": _case(
        "HardSwish", ["x"],
        {"x": np.linspace(-4, 4, 9, dtype=np.float32).reshape(1, 9)}),
    # more of the op set and its trouble spots
    "pad_constant": _case("Pad", ["x", "p", "v"], {"x": _f(5, 1, 2, 3, 4)},
                          {"p": _i64(0, 0, 1, 2, 0, 0, 2, 1),
                           "v": np.float32(0.5).reshape(())}),
    "pad_reflect": _case("Pad", ["x", "p"], {"x": _f(6, 1, 2, 4, 5)},
                         {"p": _i64(0, 0, 2, 1, 0, 0, 1, 3)},
                         {"mode": "reflect"}),
    "pad_edge": _case("Pad", ["x", "p"], {"x": _f(7, 1, 2, 4, 5)},
                      {"p": _i64(0, 0, 0, 2, 0, 0, 3, 0)}, {"mode": "edge"}),
    "cast_to_int32": _case("Cast", ["x"], {"x": _f(8, 3, 4) * 5},
                           attrs={"to": 6}),
    "cast_to_int64": _case("Cast", ["x"], {"x": _f(8, 3, 4) * 5},
                           attrs={"to": 7}),
    "cast_to_float16": _case("Cast", ["x"], {"x": _f(8, 3, 4)},
                             attrs={"to": 10}),
    "split_sizes": _case("Split", ["x", "s"], {"x": _f(9, 2, 7, 3)},
                         {"s": _i64(2, 5)}, {"axis": 1},
                         outputs=("y", "z")),
    "split_even": _case("Split", ["x"], {"x": _f(9, 2, 6, 3)},
                        attrs={"axis": 1}, outputs=("y", "z", "w")),
    "gather_on_shape": ([
        node_bytes("Shape", ["x"], ["s"]),
        node_bytes("Gather", ["s", "idx"], ["hw"], {"axis": 0}),
        node_bytes("Concat", ["lead", "hw"], ["tgt"], {"axis": 0}),
        node_bytes("Reshape", ["x", "tgt"], ["y"])],
        {"x": _f(10, 2, 3, 4, 5)}, ["x"], ["y"],
        {"idx": _i64(2, 3), "lead": _i64(-1)}, 11),
    "gather_device_negative": _case(
        "Gather", ["x", "i"], {"x": _f(11, 4, 5, 3)},
        {"i": np.array([[0, -1], [2, 1]], np.int64)}, {"axis": 1}),
    "layer_norm_graph": _layer_norm_graph() + (11,),
    "layer_normalization_op": _case(
        "LayerNormalization", ["x", "g", "b"], {"x": _f(12, 2, 4, 6)},
        {"g": _f(13, 6), "b": _f(14, 6)}, {"epsilon": 1e-5}, opset=17),
    "erf_and_gelu": _gelu_graph() + (11,),
    "conv_transpose_output_padding": _case(
        "ConvTranspose", ["x", "w", "b"], {"x": _f(15, 1, 3, 5, 6)},
        {"w": _f(16, 3, 4, 3, 3), "b": _f(17, 4)},
        {"strides": [2, 2], "pads": [1, 0, 1, 2],
         "output_padding": [1, 1]}),
    "conv_asymmetric_pads_groups_dilation": _case(
        "Conv", ["x", "w", "b"], {"x": _f(18, 1, 4, 9, 11)},
        {"w": _f(19, 6, 2, 3, 3), "b": _f(20, 6)},
        {"pads": [0, 1, 2, 0], "group": 2, "dilations": [2, 1],
         "strides": [1, 2]}),
    "conv_same_upper": _case(
        "Conv", ["x", "w"], {"x": _f(21, 1, 3, 8, 7)}, {"w": _f(22, 5, 3, 4, 4)},
        {"auto_pad": "SAME_UPPER", "strides": [2, 2]}),
    "maxpool_pads_dilation": _case(
        "MaxPool", ["x"], {"x": _f(23, 1, 2, 9, 9)},
        attrs={"kernel_shape": [3, 3], "pads": [1, 1, 1, 1],
               "dilations": [2, 2], "strides": [2, 2]}),
    "avgpool_ceil_include_pad": _case(
        "AveragePool", ["x"], {"x": _f(24, 1, 2, 7, 7)},
        attrs={"kernel_shape": [3, 3], "strides": [2, 2], "ceil_mode": 1,
               "pads": [1, 1, 0, 0], "count_include_pad": 1}),
    "avgpool_height_window": _case(
        "AveragePool", ["x"], {"x": _f(25, 2, 4, 3, 10)},
        attrs={"kernel_shape": [3, 2], "strides": [3, 2]}),
    "global_pools": ([node_bytes("GlobalAveragePool", ["x"], ["y"]),
                      node_bytes("GlobalMaxPool", ["x"], ["z"])],
                     {"x": _f(26, 2, 3, 4, 5)}, ["x"], ["y", "z"], {}, 11),
    "resize_linear_align_corners": _case(
        "Resize", ["x", "roi", "scales", "sizes"], {"x": _f(27, 1, 2, 5, 7)},
        {"roi": np.zeros(0, np.float32), "scales": np.zeros(0, np.float32),
         "sizes": _i64(1, 2, 9, 12)},
        {"mode": "linear", "coordinate_transformation_mode": "align_corners"}),
    "resize_cubic_runs_linear": _case(
        "Resize", ["x", "roi", "scales"], {"x": _f(28, 1, 1, 6, 6)},
        {"roi": np.zeros(0, np.float32),
         "scales": np.array([1, 1, 1.5, 2.5], np.float32)},
        {"mode": "cubic"}),
    "resize_nearest_round": _case(
        "Resize", ["x", "roi", "scales"], {"x": _f(29, 1, 1, 5, 4)},
        {"roi": np.zeros(0, np.float32),
         "scales": np.array([1, 1, 1.6, 0.75], np.float32)},
        {"mode": "nearest"}),
    "softmax_legacy_axis": _case("Softmax", ["x"], {"x": _f(30, 2, 3, 4)},
                                 attrs={"axis": 1}),
    "softmax_opset13": _case("Softmax", ["x"], {"x": _f(30, 2, 3, 4)},
                             attrs={"axis": 1}, opset=13),
    "log_softmax": _case("LogSoftmax", ["x"], {"x": _f(31, 3, 5)}),
    "clip_bounds": _case("Clip", ["x", "lo", "hi"], {"x": _f(32, 4, 5)},
                         {"lo": np.float32(-0.5).reshape(()),
                          "hi": np.float32(0.7).reshape(())}),
    "elementwise_chain": ([
        node_bytes("Abs", ["x"], ["a"]), node_bytes("Sqrt", ["a"], ["s"]),
        node_bytes("Exp", ["x"], ["e"]), node_bytes("Log", ["e"], ["l"]),
        node_bytes("Sub", ["s", "l"], ["d"]), node_bytes("Neg", ["d"], ["n"]),
        node_bytes("Reciprocal", ["e"], ["r"]),
        node_bytes("Max", ["n", "r"], ["m"]),
        node_bytes("Min", ["m", "c"], ["y"]),
        node_bytes("Floor", ["x"], ["f"]), node_bytes("Ceil", ["x"], ["ce"]),
        node_bytes("Round", ["x"], ["ro"]), node_bytes("Sin", ["x"], ["si"]),
        node_bytes("Cos", ["x"], ["co"]), node_bytes("Tanh", ["x"], ["t"]),
        node_bytes("Sum", ["f", "ce", "ro", "si", "co", "t"], ["z"])],
        {"x": _f(33, 3, 4) * 3}, ["x"], ["y", "z"],
        {"c": np.float32(0.25).reshape(())}, 11),
    "compare_where_logic": ([
        node_bytes("Greater", ["x", "zero"], ["g"]),
        node_bytes("LessOrEqual", ["x", "one"], ["le"]),
        node_bytes("And", ["g", "le"], ["a"]),
        node_bytes("Not", ["a"], ["na"]),
        node_bytes("Or", ["na", "g"], ["o"]),
        node_bytes("Equal", ["o", "a"], ["eq"]),
        node_bytes("Where", ["eq", "x", "zero"], ["y"]),
        node_bytes("Cast", ["o"], ["z"], {"to": 1})],
        {"x": _f(34, 4, 6)}, ["x"], ["y", "z"],
        {"zero": np.float32(0).reshape(()),
         "one": np.float32(1).reshape(())}, 11),
    "integer_div_mod_pow": ([
        node_bytes("Cast", ["x"], ["xi"], {"to": 6}),
        node_bytes("Div", ["xi", "three"], ["d"]),
        node_bytes("Mod", ["xi", "three"], ["m"]),
        node_bytes("Pow", ["x", "two"], ["p"])],
        {"x": np.arange(-6, 6, dtype=np.float32).reshape(3, 4)}, ["x"],
        ["d", "m", "p"],
        {"three": np.int32(3).reshape(()), "two": np.float32(2).reshape(())},
        11),
    "activations": ([
        node_bytes("Relu", ["x"], ["a"]),
        node_bytes("LeakyRelu", ["x"], ["b"], {"alpha": 0.1}),
        node_bytes("PRelu", ["x", "slope"], ["c"]),
        node_bytes("Sigmoid", ["x"], ["d"]),
        node_bytes("Softplus", ["x"], ["e"])],
        {"x": _f(35, 1, 3, 4, 4) * 4}, ["x"], ["a", "b", "c", "d", "e"],
        {"slope": np.array([0.1, 0.2, 0.3], np.float32)}, 11),
    "reductions": ([
        node_bytes("ReduceSum", ["x"], ["a"], {"axes": [1], "keepdims": 0}),
        node_bytes("ReduceMax", ["x"], ["b"], {"axes": [0, 2]}),
        node_bytes("ReduceMin", ["x"], ["c"]),
        node_bytes("ReduceProd", ["x"], ["d"], {"axes": [2, 1]}),
        node_bytes("ReduceL2", ["x"], ["e"], {"axes": [2]}),
        node_bytes("ReduceMean", ["x"], ["f"], {"axes": [-1]}),
        node_bytes("ArgMax", ["x"], ["g"], {"axis": 2}),
        node_bytes("ArgMin", ["x"], ["h"], {"axis": 1, "keepdims": 0})],
        {"x": _f(36, 2, 3, 4)}, ["x"], list("abcdefgh"), {}, 11),
    "topk": _case("TopK", ["x", "k"], {"x": _f(37, 3, 9)}, {"k": _i64(4)},
                  outputs=("v", "i")),
    "topk_smallest": _case("TopK", ["x", "k"], {"x": _f(38, 3, 9)},
                           {"k": _i64(3)}, {"largest": 0, "axis": 1},
                           outputs=("v", "i")),
    "matmul_einsum": ([
        node_bytes("MatMul", ["a", "b"], ["y"]),
        node_bytes("Einsum", ["a", "b"], ["z"], {"equation": "nij,jk->nik"})],
        {"a": _f(39, 2, 3, 4)}, ["a"], ["y", "z"], {"b": _f(40, 4, 5)}, 11),
    "shape_glue": ([
        node_bytes("Transpose", ["x"], ["t"], {"perm": [0, 2, 1, 3]}),
        node_bytes("Flatten", ["t"], ["f"], {"axis": 2}),
        node_bytes("Unsqueeze", ["f"], ["u"], {"axes": [0, 3]}),
        node_bytes("Squeeze", ["u"], ["s"], {"axes": [0]}),
        node_bytes("Expand", ["s", "es"], ["e"]),
        node_bytes("Tile", ["e", "reps"], ["y"]),
        node_bytes("Identity", ["y"], ["z"]),
        node_bytes("DepthToSpace", ["x"], ["d"], {"blocksize": 2}),
        node_bytes("DepthToSpace", ["x"], ["c"],
                   {"blocksize": 2, "mode": "CRD"})],
        {"x": _f(41, 1, 4, 3, 2)}, ["x"], ["z", "d", "c"],
        {"es": _i64(2, 1, 1, 1), "reps": _i64(1, 1, 2, 1)}, 11),
    "static_shape_ops": ([
        node_bytes("ConstantOfShape", ["shp"], ["c"],
                   {"value": np.array([2.5], np.float32)}),
        node_bytes("Range", ["r0", "r1", "r2"], ["r"]),
        node_bytes("Cast", ["r"], ["rf"], {"to": 1}),
        node_bytes("Mul", ["c", "rf"], ["cr"]),
        node_bytes("Add", ["x", "cr"], ["y"])],
        {"x": _f(42, 2, 4)}, ["x"], ["y"],
        {"shp": _i64(2, 4), "r0": np.array(1, np.int64),
         "r1": np.array(9, np.int64), "r2": np.array(2, np.int64)}, 11),
    "instance_norm_batchnorm": ([
        node_bytes("InstanceNormalization", ["x", "s", "b"], ["i"]),
        node_bytes("BatchNormalization", ["i", "s", "b", "m", "v"], ["y"])],
        {"x": _f(43, 2, 3, 4, 5)}, ["x"], ["y"],
        {"s": _f(44, 3), "b": _f(45, 3), "m": _f(46, 3),
         "v": np.abs(_f(47, 3)) + 0.5}, 11),
    "gather_nd": _case("GatherND", ["x", "i"], {"x": _f(48, 3, 4, 5)},
                       {"i": np.array([[0, 1], [2, 3]], np.int64)}),
}


def test_port_registers_the_jax_op_set():
    """The port runs every op the JAX executor runs, and no other."""
    assert set(ops._REGISTRY) == set(jops._REGISTRY)
    with pytest.raises(NotImplementedError, match="NoSuchOp"):
        ops.get_op("NoSuchOp")


@pytest.mark.parametrize("case", sorted(OP_CASES) + ["tiny_conv_vs_numpy"])
def test_op_case_matches_jax(case):
    """The same graph and seeded inputs through both executors."""
    if case == "tiny_conv_vs_numpy":
        blob, _ = _make_conv_model()
        feeds = {"x": _rng(2).random((1, 3, 8, 8)).astype(np.float32)}
    else:
        nodes, feeds, inputs, outputs, inits, opset = OP_CASES[case]
        blob = build_model(nodes, inputs, outputs, inits, opset)
    ref, got = _both(blob, feeds)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert r.shape == g.shape, (r.shape, g.shape)
        np.testing.assert_allclose(g.astype(np.float64),
                                   r.astype(np.float64), rtol=1e-5,
                                   atol=1e-5)


# ------------------------------------------------------- exported graphs
@pytest.fixture(scope="module")
def trees():
    """Small trees of the exported architectures: the full-width mbv3 DBNet
    (it is small), an SVTR of dim 64 over 97 classes, the classifier."""
    return {"det": dbnet.init(3), "rec": svtr.init(4, 97, dim=64),
            "cls": cls_model.init_tree(0)}


@pytest.fixture(scope="module")
def blobs(trees):
    return {k: chip_smoke.export_graph(k, t) for k, t in trees.items()}


SHAPES = {"det": (1, 3, 64, 96), "rec": (2, 3, 48, 64),
          "cls": (2, 3, 48, 192)}


@pytest.mark.parametrize("kind", ["det", "rec", "cls"])
def test_exported_graph_matches_jax_and_native(kind, trees, blobs):
    x = _rng(len(kind)).uniform(-1, 1, SHAPES[kind]).astype(np.float32)
    (ref,), (got,) = _both(blobs[kind], {"x": x})
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        if kind == "det":
            native = convert.build_dbnet(trees[kind])(xt)[:, None]
        elif kind == "rec":
            native = torch.softmax(convert.build_svtr(trees[kind])(xt), -1)
        else:
            native = convert.build_cls(trees[kind])(xt)
    np.testing.assert_allclose(got, native.numpy(), rtol=0, atol=1e-4)


def test_fold_batchnorm_matches_jax(blobs):
    """BN folding: the same node and fold counts as the JAX executor, and
    the folded graph computes the raw one's outputs."""
    m = ir.parse_model(blobs["cls"])
    opt = GraphExecutor(m, optimize=True, device="cpu")
    raw = GraphExecutor(ir.parse_model(blobs["cls"]), optimize=False,
                        device="cpu")
    jopt = JaxExecutor(jir.parse_model(blobs["cls"]), optimize=True)
    jraw = JaxExecutor(jir.parse_model(blobs["cls"]), optimize=False)
    assert opt.folded_bn == jopt.folded_bn == 35
    assert (len(opt.nodes), len(raw.nodes)) == (len(jopt.nodes),
                                                len(jraw.nodes))
    assert len(opt.nodes) < len(raw.nodes)
    x = _rng(5).uniform(-1, 1, (2, 3, 48, 192)).astype(np.float32)
    np.testing.assert_allclose(opt(x)[0].numpy(), raw(x)[0].numpy(),
                               rtol=0, atol=1e-5)


def test_executor_session_surface(blobs):
    """run / get_inputs / get_outputs as the JAX executor's; feeds as a
    dict, a list or the one input; outputs stay tensors."""
    ex = GraphExecutor(ir.parse_model(blobs["cls"]), device="cpu")
    jex = JaxExecutor(jir.parse_model(blobs["cls"]))
    x = np.zeros((1, 3, 48, 192), np.float32)
    outs = ex.run(None, {"x": x})
    assert isinstance(outs[0], np.ndarray)
    np.testing.assert_array_equal(ex.run([ex.output_names[0]], {"x": x})[0],
                                  outs[0])
    np.testing.assert_allclose(outs[0], jex.run(None, {"x": x})[0],
                               atol=1e-5)
    assert isinstance(ex([x])[0], torch.Tensor)
    np.testing.assert_array_equal(ex(x)[0].numpy(), outs[0])
    assert [i.name for i in ex.get_inputs()] == \
        [i.name for i in jex.get_inputs()] == ["x"]
    assert [o.name for o in ex.get_outputs()] == jex.output_names
    if not torch.cuda.is_available():
        # the default device is CUDA: no silent CPU run without it
        with pytest.raises(RuntimeError, match="CUDA"):
            GraphExecutor(ir.parse_model(blobs["cls"]))


# ------------------------------------------------------------ lift + init
def test_lift_cls_exact(blobs, trees):
    """lift_cls of the exported classifier: the JAX package's tree, and the
    tree it was exported from, leaf for leaf."""
    got = convert.flatten(lift.lift_cls(ir.parse_model(blobs["cls"])))
    want = convert.flatten(jlift.lift_cls(jir.parse_model(blobs["cls"])))
    src = convert.flatten(trees["cls"])
    assert set(got) == set(want) == set(src)
    for k in got:
        assert got[k].dtype == src[k].dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        np.testing.assert_array_equal(got[k], src[k])


def _not_a_cls_graph(path):
    """A classifier-shaped graph with one conv: lift_cls's ValueError."""
    w = _f(50, 4, 3, 3, 3)
    nodes = [node_bytes("Conv", ["x", "w"], ["c"], {"pads": [1, 1, 1, 1]}),
             node_bytes("GlobalAveragePool", ["c"], ["g"]),
             node_bytes("Flatten", ["g"], ["f"]),
             node_bytes("MatMul", ["f", "fc"], ["l"]),
             node_bytes("Add", ["l", "fb"], ["lb"]),
             node_bytes("Softmax", ["lb"], ["y"])]
    blob = build_model(nodes, ["x"], ["y"],
                       {"w": w, "fc": _f(51, 4, 2), "fb": _f(52, 2)})
    with open(path, "wb") as f:
        f.write(blob)
    return blob


def test_lift_cls_value_error_runs_the_graph(tmp_path):
    path = str(tmp_path / "cls.onnx")
    blob = _not_a_cls_graph(path)
    for mod, irm in ((lift, ir), (jlift, jir)):
        with pytest.raises(ValueError, match="convs, expected"):
            mod.lift_cls(irm.parse_model(blob))
    got = backends.resolve_backend("cls", path, "auto")
    want = jbackends.resolve_backend("cls", path, "auto")
    assert got[0] == want[0] == "graph" and got[2] is None


@pytest.mark.parametrize("name,port_init,jax_init", [
    ("dbnet_mbv3", lambda: dbnet.init(0, backbone_arch="mbv3"),
     lambda: jdbnet.init(0, backbone_arch="mbv3")),
    ("dbnet_resnet18", lambda: dbnet.init(0, backbone_arch="resnet18"),
     lambda: jdbnet.init(0, backbone_arch="resnet18")),
    ("svtr_v5", lambda: svtr.init(0, 18385), lambda: jsvtr.init(0, 18385)),
    ("crnn_server", lambda: crnn.init(0, 6625), lambda: jcrnn.init(0, 6625)),
])
def test_untrained_init_bit_equal(name, port_init, jax_init):
    got, want = convert.flatten(port_init()), convert.flatten(jax_init())
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k], np.asarray(want[k])), k


# --------------------------------------------------- backend resolution
@pytest.fixture(scope="module")
def stage_files(tmp_path_factory, blobs):
    """Model paths in directories without a checkpoint: a det / rec / cls
    graph that exists, and a path that does not."""
    root = tmp_path_factory.mktemp("stages")
    out = {}
    for kind in ("det", "rec", "cls"):
        d = root / "ppocrv9" / kind
        d.mkdir(parents=True)
        p = d / f"{kind}.onnx"
        p.write_bytes(blobs[kind])
        out[(kind, "file")] = str(p)
        out[(kind, "missing")] = str(d / "absent.onnx")
    return out


def _outcome(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            r = fn()
        except Exception as e:  # the exception type is the outcome
            return type(e).__name__
    return r[0], r[3], r[2] is None


@pytest.mark.parametrize("kind", ["det", "rec", "cls"])
@pytest.mark.parametrize("requested", ["auto", "native", "graph"])
@pytest.mark.parametrize("state", ["file", "missing"])
@pytest.mark.parametrize("untrained", [False, True])
def test_backend_choice_matches_jax(stage_files, monkeypatch, kind,
                                    requested, state, untrained):
    """The backend, architecture and exception of every (stage,
    tpu_backend, file) case are the JAX package's."""
    monkeypatch.delenv("ONNXOCR_TPU_ALLOW_UNTRAINED", raising=False)
    path = stage_files[(kind, state)]
    arch = "svtr" if kind == "rec" else "mbv3"
    got = _outcome(lambda: backends.resolve_backend(
        kind, path, requested, vocab_size=97, arch=arch,
        allow_untrained=untrained))
    want = _outcome(lambda: jbackends.resolve_backend(
        kind, path, requested, vocab_size=97, arch=arch,
        allow_untrained=untrained))
    assert got == want


def test_missing_native_stage_without_the_opt_in_raises(tmp_path,
                                                        monkeypatch):
    """A cls stage with no file and no checkpoint fails loudly in both
    packages; under the opt-in it is the seeded tree, with a warning."""
    monkeypatch.delenv("ONNXOCR_TPU_ALLOW_UNTRAINED", raising=False)
    path = str(tmp_path / "cls.onnx")
    for mod in (backends, jbackends):
        with pytest.raises(FileNotFoundError, match="tpu_allow_untrained"):
            mod.resolve_backend("cls", path, "native")
    with pytest.warns(UserWarning, match="randomly initialized"):
        _, _, tree, _, cal = backends.resolve_backend(
            "cls", path, "native", allow_untrained=True)
    assert cal == {}
    np.testing.assert_array_equal(tree["fc"]["w"],
                                  cls_model.init_tree(0)["fc"]["w"])


# ------------------------------------------------------------ flag table
def test_flag_table_is_honest(tmp_path):
    """Every flag of the JAX package's table is in the port's, or named as
    read by neither package or as layout-only, with its reason; no inert
    flag is read by the port; bfloat16 runs (no value is refused): the
    native stages it names compute in bfloat16 and a page goes through."""
    named = set(config.DEFAULTS) | config.INERT_FLAGS | set(config.LAYOUT_ONLY)
    assert set(jconfig.DEFAULTS) <= named, set(jconfig.DEFAULTS) - named
    assert not config.INERT_FLAGS & set(config.DEFAULTS)
    assert all(config.LAYOUT_ONLY.values())
    root = config.ASSETS.parent.parent / "onnxocr_tpu_torch"
    src = "".join(p.read_text() for p in root.rglob("*.py")
                  if p.name != "config.py")
    for flag in config.INERT_FLAGS:
        assert f"args.{flag}" not in src and \
            f'(args, "{flag}"' not in src, flag
    assert config.DEFAULTS["tpu_backend"] == "auto"
    dict_path = tmp_path / "ppocrv5_dict.txt"
    dict_path.write_text("".join(f"<{i}>\n" for i in range(18383)))
    page = np.full((96, 160, 3), 255, np.uint8)
    page[40:56, 16:144] = 0
    for key in ("tpu_dtype", "tpu_det_dtype"):
        model = ONNXPaddleOcr(device="cpu", rec_char_dict_path=str(dict_path),
                              **{key: "bfloat16"})
        det = next(model.text_detector.model.parameters()).dtype
        rec = next(model.text_recognizer.forward.model.parameters()).dtype
        assert (det, rec) == (torch.bfloat16, torch.bfloat16
                              if key == "tpu_dtype" else torch.float32)
        assert isinstance(model.ocr(page)[0], list)


# ------------------------------------------------------------- the slice
@pytest.fixture(scope="module")
def graph_zoo(tmp_path_factory, blobs):
    """tests/test_graph_e2e.py's det / rec graphs, the exported classifier,
    a graph the lift refuses, and the stand-in dictionary."""
    root = tmp_path_factory.mktemp("graphzoo")
    for kind in ("det", "rec", "cls", "nocls"):
        (root / kind).mkdir()
    _write_det_onnx(str(root / "det" / "det.onnx"))
    _write_rec_onnx(str(root / "rec" / "rec.onnx"))
    (root / "cls" / "cls.onnx").write_bytes(blobs["cls"])
    _not_a_cls_graph(str(root / "nocls" / "cls.onnx"))
    dict_path = root / "ppocrv5_dict.txt"
    dict_path.write_text("".join(f"<{i}>\n" for i in range(18383)))
    return {"det_model_dir": str(root / "det" / "det.onnx"),
            "rec_model_dir": str(root / "rec" / "rec.onnx"),
            "cls_model_dir": str(root / "cls" / "cls.onnx"),
            "nocls": str(root / "nocls" / "cls.onnx"),
            "rec_char_dict_path": str(dict_path)}


BAR = dict(use_angle_cls=False, drop_score=0.3, det_limit_side_len=320,
           tpu_det_bucket=320)


def _assert_same(got, ref):
    assert len(got) == len(ref), (len(got), len(ref))
    for (gb, (gt, gs)), (rb, (rt, rs)) in zip(got, ref):
        assert gt == rt
        assert abs(gs - rs) < 2e-3, (gs, rs)
        np.testing.assert_allclose(np.asarray(gb, np.float64),
                                   np.asarray(rb, np.float64), atol=2)


@pytest.mark.parametrize("route,extra", [
    ("bitmap", {}),
    ("device", {"tpu_det_postprocess": "device"}),
    ("onecall", {"tpu_pipeline": "onecall"}),
    ("bitmap", {"use_angle_cls": True, "label_list": ["180", "0"],
                "cls_thresh": 0.5}),
])
def test_graph_slice_matches_jax(graph_zoo, route, extra):
    """Graph det + graph rec (+ the lifted classifier) on the bar page:
    both packages pick the graph for det and rec under 'auto', and read
    the same boxes and texts."""
    kw = dict(BAR, **{k: v for k, v in graph_zoo.items() if k != "nocls"},
              **extra)
    port = ONNXPaddleOcr(device="cpu", **kw)
    ref = JaxOcr(**kw)
    assert port.route == route
    assert port.text_detector.backend == ref.text_detector.forward.backend \
        == "graph"
    assert port.text_recognizer.forward.backend == \
        ref.text_recognizer.forward.backend == "graph"
    assert not port.text_detector.masks_canvas
    assert not port.text_recognizer.forward.masks_width
    if kw["use_angle_cls"]:
        assert port.text_classifier.forward.backend == \
            ref.text_classifier.forward.backend == "native"
    got = port.ocr(_bar_page())[0]
    _assert_same(got, ref.ocr(_bar_page())[0])
    assert len(got) == len(BARS)
    port.close()


def test_graph_classifier_matches_jax(graph_zoo):
    """A cls.onnx the lift refuses runs as a graph in both packages: the
    cls-only and cls + rec forms of ocr() on crops of the bar page."""
    kw = dict(BAR, rec_char_dict_path=graph_zoo["rec_char_dict_path"],
              rec_model_dir=graph_zoo["rec_model_dir"],
              det_model_dir=graph_zoo["det_model_dir"],
              cls_model_dir=graph_zoo["nocls"], use_angle_cls=True,
              cls_thresh=0.0)
    port = ONNXPaddleOcr(device="cpu", **kw)
    ref = JaxOcr(**kw)
    assert port.text_classifier.forward.backend == \
        ref.text_classifier.forward.backend == "graph"
    page = _bar_page()
    crops = [page[y0 - 8:y1 + 8, x0 - 8:x1 + 8] for x0, y0, x1, y1 in BARS]
    got = port.ocr(crops, det=False, rec=False)[0]
    want = ref.ocr(crops, det=False, rec=False)[0]
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               atol=1e-5)
    _assert_same(port.ocr(page)[0], ref.ocr(page)[0])


@pytest.mark.parametrize("stage", ["det_model_dir", "rec_model_dir"])
def test_graph_backend_on_a_missing_file_raises(graph_zoo, tmp_path, stage):
    """tpu_backend='graph' on a missing file: FileNotFoundError in both;
    'native' on it takes the ppocrv5 checkpoint (with a warning) in both."""
    kw = dict(BAR, **{k: v for k, v in graph_zoo.items() if k != "nocls"})
    kw[stage] = str(tmp_path / "absent.onnx")
    for make in (lambda **k: ONNXPaddleOcr(device="cpu", **k), JaxOcr):
        with pytest.raises(FileNotFoundError, match="not found"):
            make(tpu_backend="graph", **kw)
    with pytest.warns(UserWarning, match="ppocrv5 family checkpoint"):
        port = ONNXPaddleOcr(device="cpu", tpu_backend="native", **kw)
    assert port.text_detector.backend == \
        port.text_recognizer.forward.backend == "native"
    assert os.path.basename(kw[stage]) == "absent.onnx"
