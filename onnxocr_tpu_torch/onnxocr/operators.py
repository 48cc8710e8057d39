"""Reference surface: onnxocr/operators.py — the config-driven host
preprocessing ops, over the port's det arithmetic (ops/det_pre.py) and its
cv2 twin of `cv2.resize` (utils/cv_ops.resize_linear). The pipeline itself
resizes and normalises on the device; these classes serve code that
composes them directly."""
import ast
import math
import operator

import numpy as np

from ..ops import det_pre
from ..utils import cv_ops

__all__ = ["NormalizeImage", "DetResizeForTest", "ToCHWImage", "KeepKeys"]

_ARITH = {ast.Add: operator.add, ast.Sub: operator.sub,
          ast.Mult: operator.mul, ast.Div: operator.truediv}


def _number(expr: str) -> float:
    """A config scale such as '1./255.': numbers and + - * / only."""
    def walk(node):
        if isinstance(node, ast.Constant) and isinstance(
                node.value, (int, float)):
            return node.value
        if isinstance(node, ast.BinOp) and type(node.op) in _ARITH:
            return _ARITH[type(node.op)](walk(node.left), walk(node.right))
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return -walk(node.operand)
        raise ValueError(f"not an arithmetic scale: {expr!r}")
    return float(walk(ast.parse(expr, mode="eval").body))


class NormalizeImage:
    """scale * x - mean / std (reference operators.py:7-31)."""

    def __init__(self, scale=None, mean=None, std=None, order="chw",
                 **kwargs):
        if isinstance(scale, str):
            scale = _number(scale)
        self.scale = np.float32(scale if scale is not None else 1.0 / 255.0)
        mean = mean if mean is not None else [0.485, 0.456, 0.406]
        std = std if std is not None else [0.229, 0.224, 0.225]
        shape = (3, 1, 1) if order == "chw" else (1, 1, 3)
        self.mean = np.array(mean).reshape(shape).astype("float32")
        self.std = np.array(std).reshape(shape).astype("float32")

    def __call__(self, data):
        img = np.asarray(data["image"])
        data["image"] = (img.astype("float32") * self.scale - self.mean) \
            / self.std
        return data


class DetResizeForTest:
    """Det resize with the reference's three modes (operators.py:34-161):
    type 0 limit_side_len rounded to /32, type 1 a fixed shape, type 2
    resize_long rounded to /128; cv2's INTER_LINEAR by its twin."""

    def __init__(self, **kwargs):
        self.resize_type = 0
        self.keep_ratio = False
        self.image_shape = None
        self.limit_side_len = 736
        self.limit_type = "min"
        self.resize_long = 960
        if "image_shape" in kwargs:
            self.image_shape = kwargs["image_shape"]
            self.resize_type = 1
            self.keep_ratio = kwargs.get("keep_ratio", False)
        elif "limit_side_len" in kwargs:
            self.limit_side_len = kwargs["limit_side_len"]
            self.limit_type = kwargs.get("limit_type", "min")
        elif "resize_long" in kwargs:
            self.resize_type = 2
            self.resize_long = kwargs.get("resize_long", 960)

    def __call__(self, data):
        img = data["image"]
        src_h, src_w = img.shape[:2]
        if src_h + src_w < 64:  # the reference pads tiny images (:57, :72)
            pad = np.zeros((max(32, src_h), max(32, src_w), img.shape[2]),
                           np.uint8)
            pad[:src_h, :src_w] = img
            img = pad
        h, w = img.shape[:2]
        if self.resize_type == 1:
            resize_h, resize_w = self.image_shape
            if self.keep_ratio:
                resize_w = int(math.ceil(w * resize_h / h / 32) * 32)
        elif self.resize_type == 2:
            resize_h, resize_w = det_pre.det_resize_long_target(
                h, w, self.resize_long)
        else:
            resize_h, resize_w = det_pre.det_resize_target(
                h, w, self.limit_side_len, self.limit_type)
        ratio_h = resize_h / float(h)
        ratio_w = resize_w / float(w)
        data["image"] = cv_ops.resize_linear(img, (int(resize_w),
                                                  int(resize_h)))
        data["shape"] = np.array([src_h, src_w, ratio_h, ratio_w])
        return data


class ToCHWImage:
    def __init__(self, **kwargs):
        pass

    def __call__(self, data):
        data["image"] = np.asarray(data["image"]).transpose((2, 0, 1))
        return data


class KeepKeys:
    def __init__(self, keep_keys, **kwargs):
        self.keep_keys = keep_keys

    def __call__(self, data):
        return [data[key] for key in self.keep_keys]
