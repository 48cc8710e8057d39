"""Config registry for the PyTorch port.

Own copy of the flag table of onnxocr_tpu/config.py (the reference kwargs
surface of ONNXPaddleOcr, plus the engine's `tpu_*` knobs). Every flag of
the JAX package's table is in `DEFAULTS`, or in `INERT_FLAGS` (read by no
path of either package), and every value the JAX package runs, the port
runs. Unknown keys are accepted and stored, as in the reference.
Every default is the JAX package's (tests/test_torch_onecall.py
`test_defaults_match_jax`): `ONNXPaddleOcr()` runs the staged pipeline's
bitmap wire with the host DB postprocess, as the JAX package does.

Model assets are read by path from the JAX package's committed data files
(`onnxocr_tpu/assets/`), never by importing that package.
"""
from __future__ import annotations

import os
from pathlib import Path
from types import SimpleNamespace

_REPO = Path(__file__).resolve().parent.parent
ASSETS = _REPO / "onnxocr_tpu" / "assets"


def find_asset(rel_path: str) -> str:
    """Resolve a model-asset path (e.g. 'ppocrv5/det/det.onnx') under
    $ONNXOCR_TPU_ASSETS or the committed asset tree; returns the committed
    tree's path when no candidate exists."""
    rel_path = rel_path.lstrip("/")
    for root in (os.environ.get("ONNXOCR_TPU_ASSETS", ""), str(ASSETS)):
        if root:
            cand = os.path.join(root, rel_path)
            if os.path.exists(cand):
                return cand
    return os.path.join(str(ASSETS), rel_path)


# flag → default for every flag a ported path reads (reference names and
# defaults)
DEFAULTS = {
    # text detector
    "det_model_dir": find_asset("ppocrv5/det/det.onnx"),
    "det_limit_side_len": 960.0,
    "det_limit_type": "max",
    "det_box_type": "quad",
    "det_db_thresh": 0.3,
    "det_db_box_thresh": 0.6,
    "det_db_unclip_ratio": 1.5,
    "use_dilation": False,
    "det_db_score_mode": "fast",
    # text recognizer
    "rec_algorithm": "SVTR_LCNet",
    "rec_model_dir": find_asset("ppocrv5/rec/rec.onnx"),
    "rec_image_shape": "3, 48, 320",
    "rec_char_dict_path": find_asset("ppocrv5/ppocrv5_dict.txt"),
    "use_space_char": True,
    "drop_score": 0.5,
    # angle classifier (no trained cls weights are committed: it runs only
    # from a native checkpoint beside cls_model_dir, or untrained under
    # tpu_allow_untrained)
    "use_angle_cls": False,
    "cls_model_dir": find_asset("ppocrv4/cls/cls.onnx"),
    "cls_image_shape": "3, 48, 192",
    "label_list": ["0", "180"],
    "cls_batch_num": 6,
    "cls_thresh": 0.9,
    # save_crop_res writes each host crop as mg_crop_<n>.jpg under
    # crop_res_save_dir (by default this package's output directory, as
    # the JAX package's is its own)
    "save_crop_res": False,
    "crop_res_save_dir": str(_REPO / "onnxocr_tpu_torch" / "output"),
    # engine knobs of the one-call and staged paths
    "tpu_det_bucket": 320,
    "tpu_rec_width_buckets": (640, 960, 1280),
    "tpu_batch_buckets": (4, 16, 64),
    "tpu_warp_interp": "bilinear",
    # crop warp form ('off' | 'upright' | 'shear', ops/warp.warp_crops) and
    # the shear form's eligibility bound in px; the JAX package's static
    # slot budget for its gather leg is accepted and stored, and read by no
    # ported path (ops/warp.py)
    "tpu_warp_stage": "shear",
    "tpu_warp_stage_tol": 0.35,
    "tpu_warp_slow_k": 16,
    # 'staged' (routed by the det flags below, pipeline/system.py) or
    # 'onecall' (pipeline/onecall.py)
    "tpu_pipeline": "staged",
    "tpu_fused_cls_rec": True,
    # the staged det route: 'host' DB postprocess (contours, min-area
    # rects, unclip from the C++ host library) or 'device' DB extraction
    "tpu_det_postprocess": "host",
    # the host postprocess's wire: 'bitmap' downloads the bitpacked DB
    # bitmap and scores the candidates on the device in the fused rec pass;
    # 'map' downloads the map in tpu_det_map_dtype ('uint8' floors to
    # 1/255, 'float16', 'float32') and scores on the host
    "tpu_det_wire": "bitmap",
    "tpu_det_map_dtype": "uint8",
    # 'device': the det input is resized on the device from the uploaded
    # page; 'host': resized on the host with cv2's pixels
    # (det_pre.prepare_det_input) and uploaded
    "tpu_det_input": "device",
    # the bitmap wire's det canvas: 'always' one square canvas of the limit
    # side; 'auto' and 'never' the page's own (the JAX package fixes it
    # under 'auto' on the TPU only)
    "tpu_det_fixed_canvas": "auto",
    "tpu_det_max_boxes": 1024,
    "tpu_det_extract_scale": "1x2",
    "tpu_det_score_scale": "1x1",
    "tpu_det_score_k": 128,
    "tpu_det_axis_snap": 0.0,
    "tpu_db_reduce": "pallas2",
    "tpu_allow_untrained": False,
    # each stage's backend (pipeline/backends.resolve_backend): 'auto' runs
    # a det / rec .onnx that exists as a graph (onnx/executor.py) and lifts
    # a cls.onnx into the native classifier, else the native checkpoint;
    # 'native' never runs a graph; 'graph' always does
    "tpu_backend": "auto",
    # compute dtype of the native models ('float32' or 'bfloat16': the
    # native stages' parameters cast, models/common.tree_cast, and their
    # inputs; graph stages ignore it), and the det forward's override ('':
    # follows tpu_dtype)
    "tpu_dtype": "float32",
    "tpu_det_dtype": "",
    # the source page's upload wire in the JAX package ('flat': content
    # only, edge-padded on the device; 'padded'; 'auto'); a layout choice
    # only (LAYOUT_ONLY): the port uploads the edge-padded canvas whatever
    # its value
    "tpu_src_upload": "auto",
    "tpu_det_extract_window": 320,
    "tpu_onecall_rec_width": 640,
    "tpu_onecall_max_boxes": 48,
    "tpu_onecall_det_candidates": 1024,
    # one square det canvas (round_up(limit, det bucket)²) for every page
    # of the one-call program, else the page's own bucket canvas
    "tpu_onecall_fixed_canvas": True,
    # the one-call wave coalescer (pipeline/onecall._WaveCoalescer):
    # concurrent calls' pages run as one multi-page step at the largest
    # warmed page count of the tiers; off for the library (it adds a
    # dispatcher thread), as in the JAX package
    "tpu_onecall_wave": False,
    "tpu_onecall_wave_tiers": "2,4",
    "tpu_decode_support": "trained",
    # cross-request batching (runtime/batcher.py), off for the library: the
    # det batcher runs concurrent pages' DBNet forwards as one call on the
    # fixed det canvas; the rec batcher runs concurrent pages' crop chunks
    # as one multi-page scored pass. Each adds up to tpu_microbatch_wait_ms
    # to a call. 'device': the batched det canvas is resized on the device
    # from the uploaded page; 'host': on the host with cv2's pixels
    "tpu_det_microbatch": False,
    "tpu_det_batch_input": "device",
    # 'device': crops are warped on the device from the uploaded page;
    # 'host': the reference's host crops (cv2's pixels, utils/cv_ops.py)
    # through the classifier's and recognizer's crop-list paths
    "tpu_crop_backend": "device",
    "tpu_rec_microbatch": False,
    "tpu_microbatch_wait_ms": 8.0,
}


# The reference's kwargs surface that no path of either package reads (the
# EAST / SAST / PSE / FCE / SR / e2e / multi-process groups, the Paddle
# inference engine's settings and output dirs): accepted and stored when
# passed, as by the JAX package, and read by nothing.
INERT_FLAGS = frozenset((
    "use_gpu", "use_xpu", "use_npu", "ir_optim", "use_tensorrt",
    "min_subgraph_size", "precision", "gpu_mem", "gpu_id", "image_dir",
    "page_num", "det_algorithm", "max_batch_size",
    "det_east_score_thresh", "det_east_cover_thresh", "det_east_nms_thresh",
    "det_sast_score_thresh", "det_sast_nms_thresh", "det_pse_thresh",
    "det_pse_box_thresh", "det_pse_min_area", "det_pse_scale", "scales",
    "alpha", "beta", "fourier_degree", "rec_image_inverse", "rec_batch_num",
    "max_text_length", "vis_font_path", "e2e_algorithm", "e2e_model_dir",
    "e2e_limit_side_len", "e2e_limit_type", "e2e_pgnet_score_thresh",
    "e2e_char_dict_path", "e2e_pgnet_valid_set", "e2e_pgnet_mode",
    "enable_mkldnn", "cpu_threads", "use_pdserving", "warmup",
    "sr_model_dir", "sr_image_shape", "sr_batch_num", "draw_img_save_dir",
    "use_mp", "total_process_num", "process_id", "benchmark",
    "save_log_path", "show_log", "use_onnx"))

# flags whose every value gives the same results, with the reason
LAYOUT_ONLY = {
    "tpu_src_upload": "the JAX package's flat upload rebuilds the "
                      "edge-padded canvas on the device, bit-identical to "
                      "the host pad (resize_dev.put_src_bucket), which the "
                      "port uploads for every value",
}

def make_params() -> SimpleNamespace:
    """A fresh namespace of the defaults."""
    return SimpleNamespace(**DEFAULTS)


def parse_shape(s) -> tuple:
    """Parse "3, 48, 320" → (3, 48, 320)."""
    if isinstance(s, (tuple, list)):
        return tuple(int(v) for v in s)
    return tuple(int(v) for v in str(s).split(","))
