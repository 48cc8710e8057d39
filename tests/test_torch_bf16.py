"""bfloat16 compute (tpu_dtype / tpu_det_dtype = 'bfloat16') of the port
against the JAX package's on the CPU.

The JAX package casts a native stage's whole tree to bfloat16 and its input
too; its layers then multiply bfloat16 operands into float32
(preferred_element_type), so every activation after the first layer is
float32. Neither package's bfloat16 result equals its float32 one, and
rounding details (XLA keeps some bfloat16 intermediates in float32, see
models/common.BatchNorm) move it further. The bar is therefore relative:
the port's bfloat16 output must be no farther from the JAX package's
bfloat16 output than that is from the JAX package's float32 output — for
each native architecture's forward (det map max abs, rec argmax
disagreement, cls probability max abs) and for `ocr()` on a held-out page
on paths C, B and A (lines that differ by the repo's same-result rule:
unmatched, another text, a box corner more than 2 px off or a score more
than 2e-3 off). Both distances are printed.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from onnxocr_tpu import ONNXPaddleOcr as JaxOcr
from onnxocr_tpu.models import cls as jcls
from onnxocr_tpu.models import common as jcm
from onnxocr_tpu.models import crnn as jcrnn
from onnxocr_tpu.models import dbnet as jdbnet
from onnxocr_tpu.models import svtr as jsvtr

from onnxocr_tpu_torch import ONNXPaddleOcr, config
from onnxocr_tpu_torch.models import convert
from onnxocr_tpu_torch.ops import det_pre
from onnxocr_tpu_torch.utils.params_io import load_tree
from onnxocr_tpu_torch.utils.png import read_bgr

HELDOUT = config.ASSETS.parent / "test_images_heldout"
PAGES = ("synth_00_doc", "synth_08_table")


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
    return {n: read_bgr(str(HELDOUT / f"{n}.png")) for n in PAGES}


def _strips(pages, h, w, n=4):
    """n (h, w) strips a page, top-left corners spread down the page, as
    float32 in [−1, 1] (N, h, w, 3)."""
    out = []
    for img in pages.values():
        for y in np.linspace(8, img.shape[0] - h - 8, n).astype(int):
            out.append(img[y:y + h, :w].astype(np.float32) / 127.5 - 1.0)
    return np.stack(out)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _three(jax_apply, tree, build, x):
    """(JAX float32, JAX bfloat16, port bfloat16) outputs of one forward on
    x (N, H, W, 3), each package casting its tree and its input as its
    pipeline's bfloat16 stages do."""
    fn = jax.jit(lambda p, v, dt: jax_apply(p, v.astype(dt))
                 .astype(jnp.float32), static_argnums=2)
    jf = np.asarray(fn(tree, x, jnp.float32))
    jb = np.asarray(fn(jcm.tree_cast(tree, jnp.bfloat16), x, jnp.bfloat16))
    model = build(tree, dtype=torch.bfloat16)
    with torch.no_grad():
        tb = model(_nchw(x).to(torch.bfloat16))
    return jf, jb, tb.float().numpy()


def _bar(name, ours, theirs):
    print(f"{name}: port-bf16 vs JAX-bf16 {ours:.4g}, JAX-bf16 vs JAX-f32 "
          f"{theirs:.4g}")
    assert ours <= theirs, (name, ours, theirs)


# ------------------------------------------------------------ forwards
@pytest.mark.parametrize("arch,ckpt", [("mbv3", "ppocrv5/det"),
                                       ("resnet18",
                                        "ch_ppocr_server_v2.0/det")])
def test_dbnet_bf16_forward(pages, arch, ckpt):
    tree = load_tree(str(config.ASSETS / ckpt / "native_params.npz"))
    img = pages[PAGES[0]][:320, :320]
    x = det_pre.normalize_det(torch.from_numpy(
        np.ascontiguousarray(img)))[None].numpy()
    jf, jb, tb = _three(
        lambda p, v: jdbnet.apply(p, v, backbone_arch=arch), tree,
        lambda t, dtype: convert.build_dbnet(t, arch=arch, dtype=dtype), x)
    _bar(f"DBNet {arch} map max abs", np.abs(tb - jb).max(),
         np.abs(jb - jf).max())


@pytest.mark.parametrize("arch,ckpt", [("svtr", "ppocrv5/rec"),
                                       ("crnn", "ch_ppocr_server_v2.0/rec")])
def test_rec_bf16_forward(pages, arch, ckpt):
    """Argmax disagreement over every (crop, step) of 8 strips 48 × 320."""
    tree = load_tree(str(config.ASSETS / ckpt / "native_params.npz"))
    x = _strips(pages, 48, 320)
    jmod, build = (jsvtr, convert.build_svtr) if arch == "svtr" else \
        (jcrnn, convert.build_crnn)
    jf, jb, tb = _three(jmod.apply, tree, build, x)
    ours = np.mean(tb.argmax(-1) != jb.argmax(-1))
    theirs = np.mean(jb.argmax(-1) != jf.argmax(-1))
    print(f"{arch} logits max abs: port-bf16 vs JAX-bf16 "
          f"{np.abs(tb - jb).max():.4g}, JAX-bf16 vs JAX-f32 "
          f"{np.abs(jb - jf).max():.4g}")
    _bar(f"{arch} argmax disagreement", ours, theirs)


def test_cls_bf16_forward(pages):
    tree = jcls.init(0)
    x = _strips(pages, 48, 192)
    jf, jb, tb = _three(jcls.apply, tree, convert.build_cls, x)
    _bar("cls probability max abs", np.abs(tb - jb).max(),
         np.abs(jb - jf).max())


def test_bf16_stages_keep_float32_weights_for_the_head_kernel():
    """Under bfloat16 the SVTR's leaves are bfloat16, and the head kernel's
    operand is split (prepare) after the cast, from the bfloat16-rounded
    head held in float32, as the JAX head wrapper casts it."""
    tree = jsvtr.init(0, 64)
    model = convert.build_svtr(tree, dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    w = model.head.w.float()
    assert model.head.w_split.dtype == torch.float32
    np.testing.assert_array_equal((model.head.w_split[0] +
                                   model.head.w_split[1]).t().numpy(),
                                  w.numpy())


# ------------------------------------------------------------ ocr()
def _same_line(a, b):
    return a[1][0] == b[1][0] and abs(float(a[1][1]) - float(b[1][1])) \
        <= 2e-3 and np.abs(np.asarray(a[0], np.float64) -
                           np.asarray(b[0], np.float64)).max() <= 2.0


def lines_differing(a, b) -> int:
    """Lines of two ocr() results that are not the same result: each line
    of a is matched to the unused line of b whose box centre is nearest
    (within 8 px); unmatched lines on either side count, and matched ones
    that differ in text, score (2e-3) or box (2 px)."""
    def centre(line):
        return np.asarray(line[0], np.float64).mean(0)

    used, n = set(), 0
    for line in a:
        dists = [np.abs(centre(line) - centre(o)).max()
                 if j not in used else np.inf for j, o in enumerate(b)]
        j = int(np.argmin(dists)) if dists else -1
        if j < 0 or dists[j] > 8:
            n += 1
            continue
        used.add(j)
        n += not _same_line(line, b[j])
    return n + len(b) - len(used)


@pytest.fixture(scope="module")
def dict_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("dict") / "ppocrv5_dict.txt"
    path.write_text("".join(f"<{i}>\n" for i in range(18383)))
    return str(path)


BASE = dict(drop_score=0.0, det_limit_side_len=320, tpu_warp_stage="off")
PATHS = {"C": {},
         "B": dict(tpu_pipeline="onecall", use_angle_cls=False),
         "A": dict(tpu_pipeline="staged", tpu_det_postprocess="device",
                   tpu_db_reduce="pallas", use_angle_cls=True,
                   tpu_allow_untrained=True)}


@pytest.mark.parametrize("path,flag", [("C", "tpu_dtype"),
                                       ("B", "tpu_dtype"),
                                       ("A", "tpu_dtype"),
                                       ("C", "tpu_det_dtype")])
def test_ocr_bf16_matches_jax(pages, dict_path, path, flag):
    kw = dict(BASE, rec_char_dict_path=dict_path, **PATHS[path])
    cls = kw.get("use_angle_cls", False)
    img = pages[PAGES[0]]
    jf = JaxOcr(**kw).ocr(img, cls=cls)[0]
    jb = JaxOcr(**kw, **{flag: "bfloat16"}).ocr(img, cls=cls)[0]
    port = ONNXPaddleOcr(device="cpu", **kw, **{flag: "bfloat16"})
    tb = port.ocr(img, cls=cls)[0]
    assert len(tb) > 4
    det = port.text_detector.model
    assert next(det.parameters()).dtype == torch.bfloat16
    rec = port.text_recognizer.forward.model
    assert next(rec.parameters()).dtype == (
        torch.bfloat16 if flag == "tpu_dtype" else torch.float32)
    _bar(f"path {path} {flag}=bfloat16 lines differing",
         lines_differing(tb, jb), lines_differing(jb, jf))
