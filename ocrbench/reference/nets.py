"""The plain networks of the two configurations, in float32 PyTorch
functions over the checkpoint's flat arrays (`load(path)`: the committed
`native_params.npz`, keys such as `backbone/blocks/#3/dw/conv/w`, HWIO
convolution kernels and (in, out) linear weights).

* `dbnet(p, x, arch)`: the DB detector, a MobileNetV3-large (×0.5) or a
  ResNet18-vd backbone, the DB FPN (laterals 96, smooth 24) and the
  binarization head → the shrink probability map;
* `svtr(p, x)`: the SVTR-LCNet recognizer's logits (stem, six
  depthwise-separable stages, neck, as many mixer blocks as the
  checkpoint holds (six in the committed one), the CTC head);
* `crnn(p, x)`: the CRNN recognizer's logits (five conv stages, mean over
  the height, two bidirectional LSTMs of 256, the head).

Written from the published designs these networks follow (DB, arXiv
1911.08947; SVTR-LCNet, arXiv 2206.03001; CRNN, arXiv 1507.05717) at the
committed checkpoints' own widths (each configuration file lists where
they depart), in the forms the checkpoints were trained in: hardswish x·
clip(x/6 + ½), hardsigmoid clip(0.2x + ½), batch norm with eps 1e-5,
convolutions padded k // 2 on both sides, LayerNorm eps 1e-6, GELU by its
tanh form, attention heads of 32. The caller keeps TF32 off."""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

MBV3_LARGE = [  # kernel, expand, out, se, act, stride (before ×0.5)
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hswish", 2), (3, 200, 80, False, "hswish", 1),
    (3, 184, 80, False, "hswish", 1), (3, 184, 80, False, "hswish", 1),
    (3, 480, 112, True, "hswish", 1), (3, 672, 112, True, "hswish", 1),
    (5, 672, 160, True, "hswish", 2), (5, 960, 160, True, "hswish", 1),
    (5, 960, 160, True, "hswish", 1)]
DB_TAPS = (3, 6, 12)   # block inputs at 1/4, 1/8, 1/16
SVTR_STRIDES = ((2, 1), (1, 1), (2, 2), (1, 1), (2, 1), (1, 1))
CRNN_STRIDES = ((2, 2), (2, 2), (2, 1), (3, 1))


def load(path: str, device) -> Params:
    with np.load(path) as z:
        return {k: torch.as_tensor(np.asarray(z[k], np.float32)).to(device)
                for k in z.files}


def _hswish(x):
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def _act(x, act):
    if act == "relu":
        return F.relu(x)
    if act == "hswish":
        return _hswish(x)
    return x


def conv(p: Params, name: str, x, stride=1, groups: int = 1):
    w = p[name + "/w"].permute(3, 2, 0, 1)        # HWIO → OIHW
    k = w.shape[-1]
    return F.conv2d(x, w, p.get(name + "/b"), stride, k // 2, 1, groups)


def bn(p: Params, name: str, x):
    inv = p[name + "/scale"] * torch.rsqrt(p[name + "/var"] + 1e-5)
    shift = p[name + "/bias"] - p[name + "/mean"] * inv
    return x * inv[:, None, None] + shift[:, None, None]


def convbn(p, name, x, stride=1, groups=1, act="none"):
    return _act(bn(p, name + "/bn", conv(p, name + "/conv", x, stride,
                                         groups)), act)


def _zero_outside(x, valid, stride):
    """Zero x beyond the page's extent at this stride (ceil(v / s))."""
    if valid is None:
        return x
    vh, vw = ((v + stride - 1) // stride for v in valid)
    x = x.clone()
    x[:, :, vh:] = 0
    x[:, :, :, vw:] = 0
    return x


def _mbv3(p: Params, x, valid=None):
    """With `valid` = (vh, vw), the page's extent on a larger canvas: the
    canvas outside the page is zeroed at the input and at every block's
    output, and squeeze-excitation pools over the page alone."""
    x = _zero_outside(x, valid, 1)
    x = _zero_outside(convbn(p, "backbone/stem", x, 2, act="hswish"),
                      valid, 2)
    stride = 2
    feats = []
    for i, (k, exp, cout, se, act, s) in enumerate(MBV3_LARGE):
        if i in DB_TAPS:
            feats.append(x)
        name = f"backbone/blocks/#{i}"
        y = convbn(p, name + "/expand", x, act=act)
        y = convbn(p, name + "/dw", y, s, groups=y.shape[1], act=act)
        stride *= s
        if se:
            if valid is None:
                s_ = y.mean(dim=(2, 3), keepdim=True)
            else:
                vh, vw = ((v + stride - 1) // stride for v in valid)
                s_ = y[:, :, :vh, :vw].sum(dim=(2, 3), keepdim=True) / \
                    max(vh * vw, 1)
            s_ = F.relu(conv(p, name + "/se/reduce", s_))
            s_ = torch.clamp(0.2 * conv(p, name + "/se/expand", s_) + 0.5,
                             0.0, 1.0)
            y = y * s_
        y = convbn(p, name + "/project", y)
        if s == 1 and x.shape[1] == y.shape[1]:
            y = y + x
        x = _zero_outside(y, valid, stride)
    feats.append(_zero_outside(convbn(p, "backbone/last", x, act="hswish"),
                               valid, stride))
    return feats


def _resnet18vd(p: Params, x):
    for i in range(3):
        x = convbn(p, f"backbone/stem/#{i}", x, 2 if i == 0 else 1,
                   act="relu")
    x = F.max_pool2d(x, 2, 2)
    feats = []
    for si in range(4):
        for bi in range(2):
            name = f"backbone/stages/#{si}/#{bi}"
            stride = 2 if si > 0 and bi == 0 else 1
            y = convbn(p, name + "/conv1", x, stride, act="relu")
            y = convbn(p, name + "/conv2", y)
            short = F.avg_pool2d(x, 2, 2) if stride != 1 else x
            if name + "/short/conv/w" in p:
                short = convbn(p, name + "/short", short)
            x = F.relu(y + short)
        feats.append(x)
    return feats


def _up2(x):
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def _deconv2(p: Params, name: str, x):
    # the checkpoint's (2, 2, in, out) kernel is applied unflipped
    w = p[name + "/w"].flip(0, 1).permute(2, 3, 0, 1)
    return F.conv_transpose2d(x, w, p[name + "/b"], 2)


def dbnet(p: Params, x, arch: str, valid=None):
    """x (N, 3, H, W) ImageNet-normalized, H and W multiples of 32 → (N, H,
    W) shrink probabilities. `valid` (MobileNetV3 only): the page's
    (height, width) on the canvas x, outside which the backbone's and the
    FPN's activations are zeroed."""
    feats = _resnet18vd(p, x) if arch == "resnet18" else \
        _mbv3(p, x, valid)
    lat = [conv(p, f"lateral/#{i}", f) for i, f in enumerate(feats)]
    for i in range(len(lat) - 1, 0, -1):
        up = lat[i]
        while up.shape[2] < lat[i - 1].shape[2]:
            up = _up2(up)
        lat[i - 1] = lat[i - 1] + up
    outs = [conv(p, f"smooth/#{i}", f) for i, f in enumerate(lat)]
    ups = []
    for o in outs:
        while o.shape[2] < outs[0].shape[2]:
            o = _up2(o)
        ups.append(o)
    fused = _zero_outside(torch.cat(ups, 1), valid, 4)
    y = convbn(p, "head/conv", fused, act="relu")
    y = F.relu(bn(p, "head/bn1", _deconv2(p, "head/up1", y)))
    return torch.sigmoid(_deconv2(p, "head/up2", y)[:, 0])


def _linear(p: Params, name: str, x):
    return x @ p[name + "/w"] + p[name + "/b"]


def _layernorm(p: Params, name: str, x):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-6) * p[name + "/scale"] + \
        p[name + "/bias"]


def svtr_features(p: Params, x):
    """x (N, 3, 48, W), W a multiple of 8 → (N, W/8, D)."""
    x = convbn(p, "stem", x, 2, act="hswish")
    for i, s in enumerate(SVTR_STRIDES):
        x = convbn(p, f"stages/#{i}/dw", x, s, groups=x.shape[1],
                   act="hswish")
        x = convbn(p, f"stages/#{i}/pw", x, act="hswish")
    x = convbn(p, "neck", x, act="hswish")
    x = F.avg_pool2d(x, (x.shape[2], 2), (x.shape[2], 2))[:, :, 0]
    x = x.transpose(1, 2)
    d = x.shape[-1]
    heads = max(1, d // 32)
    i = 0
    while f"mixer/#{i}/qkv/w" in p:
        m = f"mixer/#{i}"
        n, t, _ = x.shape
        qkv = _linear(p, m + "/qkv", _layernorm(p, m + "/ln1", x))
        qkv = qkv.reshape(n, t, 3, heads, d // heads)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d // heads),
                            -1)
        o = (att @ v).transpose(1, 2).reshape(n, t, d)
        x = x + _linear(p, m + "/proj", o)
        y = _linear(p, m + "/fc1", _layernorm(p, m + "/ln2", x))
        x = x + _linear(p, m + "/fc2", F.gelu(y, approximate="tanh"))
        i += 1
    return x


def svtr(p: Params, x):
    return _linear(p, "head", svtr_features(p, x))


def _bilstm(p: Params, name: str, x):
    """(N, T, D) → (N, T, 512): the two directions run over the whole
    sequence, gates i, f, g, o, one bias a direction."""
    wi, wh, b = p[name + "/wi"], p[name + "/wh"], p[name + "/b"]
    n, t, _ = x.shape
    hid = wh.shape[-1]
    outs = []
    for d in range(2):
        xs = x @ wi[d].T + b[d]                      # (N, T, 4H)
        h = x.new_zeros(n, hid)
        c = x.new_zeros(n, hid)
        seq = [None] * t
        steps = range(t) if d == 0 else range(t - 1, -1, -1)
        for s in steps:
            g = xs[:, s] + h @ wh[d].T
            i_, f_, g_, o_ = g.chunk(4, -1)
            c = torch.sigmoid(f_) * c + torch.sigmoid(i_) * torch.tanh(g_)
            h = torch.sigmoid(o_) * torch.tanh(c)
            seq[s] = h
        outs.append(torch.stack(seq, 1))
    return torch.cat(outs, -1)


def crnn_features(p: Params, x):
    x = convbn(p, "stem", x, act="relu")
    for i, s in enumerate(CRNN_STRIDES):
        x = convbn(p, f"stages/#{i}", x, s, act="relu")
    return x.mean(dim=2).transpose(1, 2)


def crnn(p: Params, x):
    """x (N, 3, 48, W) → (N, W/4, V) logits."""
    y = _bilstm(p, "lstm2", _bilstm(p, "lstm1", crnn_features(p, x)))
    return _linear(p, "head", y)
