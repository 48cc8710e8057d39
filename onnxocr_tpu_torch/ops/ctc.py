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
            keep &= idx != 0  # blank
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


class ClsPostProcess:
    """Angle-classifier postprocess: (N, C) probabilities → [(label,
    score)] of each row's argmax."""

    def __init__(self, label_list=None):
        self.label_list = label_list

    def __call__(self, preds) -> List[Tuple[str, float]]:
        preds = np.asarray(preds)
        label_list = self.label_list
        if label_list is None:
            label_list = {i: i for i in range(preds.shape[-1])}
        return [(label_list[i], float(preds[n, i]))
                for n, i in enumerate(preds.argmax(axis=1))]
