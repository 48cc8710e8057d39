"""CTC decoding: on-device argmax/max-prob reduce + host string assembly.

Port of onnxocr_tpu/ops/ctc.py: `ctc_reduce` reduces a rec graph's
probabilities, `ctc_reduce_logits` is the plain form of the fused head
(ops/kernels/ctc_head.py), `CTCLabelDecode` is a copy of the
reference host decoder (rec_postprocess.py contract: blank at index 0,
optional space appended, dedup then drop blank, mean confidence), and
`ClsPostProcess` is the angle classifier's (label, score) postprocess.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def ctc_reduce(probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., V) probabilities (a rec graph's softmax output) → ((...)
    first-index argmax int32, (...) max prob)."""
    return torch.argmax(probs, dim=-1).to(torch.int32), \
        torch.amax(probs, dim=-1)


def ctc_reduce_logits(logits: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., V) logits → ((...) first-index argmax int32, (...) softmax
    max-prob exp(max − logsumexp))."""
    idx = torch.argmax(logits, dim=-1).to(torch.int32)
    mx = torch.amax(logits, dim=-1)
    lse = torch.log(torch.sum(torch.exp(logits - mx[..., None]), dim=-1)) + mx
    return idx, torch.exp(mx - lse)


class CTCLabelDecode:
    """Host decoder with the reference's exact contract."""

    def __init__(self, character_dict_path: Optional[str] = None,
                 use_space_char: bool = False):
        self.reverse = False
        chars: List[str] = []
        if character_dict_path is None:
            chars = list("0123456789abcdefghijklmnopqrstuvwxyz")
        else:
            with open(character_dict_path, "rb") as f:
                for line in f.readlines():
                    chars.append(line.decode("utf-8").strip("\n")
                                 .strip("\r\n"))
            if use_space_char:
                chars.append(" ")
            if "arabic" in character_dict_path:
                self.reverse = True
        self.character: List[str] = ["blank"] + chars
        self.dict = {c: i for i, c in enumerate(self.character)}

    def get_ignored_tokens(self) -> List[int]:
        return [0]

    def pred_reverse(self, pred: str) -> str:
        segments: List[str] = []
        current = ""
        for ch in pred:
            if not bool(re.search("[a-zA-Z0-9 :*./%+-]", ch)):
                if current != "":
                    segments.append(current)
                segments.append(ch)
                current = ""
            else:
                current += ch
        if current != "":
            segments.append(current)
        return "".join(segments[::-1])

    def decode_indices(self, text_index: np.ndarray,
                       text_prob: Optional[np.ndarray] = None,
                       is_remove_duplicate: bool = False,
                       valid_t: Optional[Sequence[int]] = None
                       ) -> List[Tuple[str, float]]:
        """text_index/text_prob: (N, T). valid_t limits each row to its
        un-padded time steps."""
        results: List[Tuple[str, float]] = []
        for b in range(len(text_index)):
            t_end = len(text_index[b]) if valid_t is None else int(valid_t[b])
            idx = np.asarray(text_index[b][:t_end])
            keep = np.ones(len(idx), dtype=bool)
            if is_remove_duplicate:
                keep[1:] = idx[1:] != idx[:-1]
            for ignored in self.get_ignored_tokens():
                keep &= idx != ignored
            chars = [self.character[i] for i in idx[keep]]
            if text_prob is not None:
                confs = np.asarray(text_prob[b][:t_end])[keep]
            else:
                confs = np.ones(len(idx), dtype=np.float32)[: len(keep)]
            if len(confs) == 0:
                confs = np.array([0.0])
            text = "".join(chars)
            if self.reverse:
                text = self.pred_reverse(text)
            results.append((text, float(np.mean(confs))))
        return results

    def __call__(self, preds, label=None, valid_t=None):
        """(N, T, V) probabilities (the reference's contract), or an
        ((N, T) index, (N, T) probability) pair as ctc_reduce gives; numpy
        or torch on any device. With `label`, also its decode."""
        if isinstance(preds, (tuple, list)) and len(preds) == 2 and (
                np.ndim(_host(preds[0])) == 2):
            idx, prob = _host(preds[0]), _host(preds[1])
        else:
            if isinstance(preds, (tuple, list)):
                preds = preds[-1]
            preds = _host(preds)
            idx = preds.argmax(axis=2)
            prob = preds.max(axis=2)
        text = self.decode_indices(idx, prob, is_remove_duplicate=True,
                                   valid_t=valid_t)
        if label is None:
            return text
        return text, self.decode_indices(_host(label))


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


class ClsPostProcess:
    """Angle-classifier postprocess: (N, C) probabilities → [(label,
    score)] of each row's argmax."""

    def __init__(self, label_list=None):
        self.label_list = label_list

    def __call__(self, preds, label=None) -> List[Tuple[str, float]]:
        preds = _host(preds)
        label_list = self.label_list
        if label_list is None:
            label_list = {i: i for i in range(preds.shape[-1])}
        return [(label_list[i], float(preds[n, i]))
                for n, i in enumerate(preds.argmax(axis=1))]


class DistillationCTCLabelDecode(CTCLabelDecode):
    """The multi-head CTC decode (reference rec_postprocess.py:116-150):
    each named head's output decoded as CTCLabelDecode does."""

    def __init__(self, character_dict_path=None, use_space_char=False,
                 model_name=("student",), key=None, multi_head=False,
                 **kwargs):
        super().__init__(character_dict_path, use_space_char)
        if not isinstance(model_name, (list, tuple)):
            model_name = [model_name]
        self.model_name = list(model_name)
        self.key = key
        self.multi_head = multi_head

    def __call__(self, preds, label=None, *args, **kwargs):
        output = {}
        for name in self.model_name:
            pred = preds[name]
            if self.key is not None:
                pred = pred[self.key]
            if self.multi_head and isinstance(pred, dict):
                pred = pred["ctc"]
            output[name] = super().__call__(pred, label=label)
        return output
