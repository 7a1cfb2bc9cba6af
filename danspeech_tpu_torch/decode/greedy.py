"""Greedy CTC decoding (host side).

The argmax runs on the device inside the engine's forward program; the
collapse (drop blanks + merge repeats, with per-character frame offsets) is
a vectorized numpy pass over the small (B, T) integer paths. A copy of
``danspeech_tpu.decode.greedy`` with the device argmax done in torch.
"""

from __future__ import annotations

import numpy as np
import torch

from .metrics import cer as _cer
from .metrics import wer as _wer


class Decoder:
    """Base decoder: label bookkeeping + WER/CER helpers."""

    def __init__(self, labels: str, blank_index: int = 0):
        self.labels = labels
        self.int_to_char = dict(enumerate(labels))
        self.blank_index = blank_index
        self.space_index = labels.index(" ") if " " in labels else len(labels)

    def wer(self, s1: str, s2: str) -> int:
        return _wer(s1, s2)

    def cer(self, s1: str, s2: str) -> int:
        return _cer(s1, s2)

    def decode(self, probs, sizes=None):
        raise NotImplementedError


def collapse_sequence(
    seq: np.ndarray, size: int, labels: str, blank_index: int
) -> tuple[str, np.ndarray]:
    """Collapse an argmax path: merge repeats, drop blanks, keep offsets."""
    seq = np.asarray(seq[:size])
    if seq.size == 0:
        return "", np.zeros((0,), dtype=np.int32)
    prev = np.concatenate(([blank_index], seq[:-1]))
    keep = (seq != blank_index) & (seq != prev)
    offsets = np.nonzero(keep)[0].astype(np.int32)
    chars = [labels[i] for i in seq[keep]]
    return "".join(chars), offsets


def collapse_batch(
    paths: np.ndarray, sizes: np.ndarray, labels: str, blank_index: int
) -> list[str]:
    """Collapse a whole (B, T) argmax-path matrix in one vectorized pass:
    the keep mask (non-blank, not a repeat, inside the row's valid length)
    is computed for the full matrix, the kept label ids index a unicode
    label table once, and per-row strings fall out of a single join +
    cumulative split."""
    paths = np.asarray(paths)
    batch, t = paths.shape
    if t == 0:
        return [""] * batch
    valid = np.arange(t)[None, :] < np.asarray(sizes, dtype=np.int64)[:, None]
    prev = np.empty_like(paths)
    prev[:, 0] = blank_index
    prev[:, 1:] = paths[:, :-1]
    keep = valid & (paths != blank_index) & (paths != prev)
    label_table = np.array(list(labels))
    flat = label_table[paths[keep]]
    joined = "".join(flat.tolist())
    bounds = np.cumsum(keep.sum(axis=1))
    out, start = [], 0
    for b in range(batch):
        end = int(bounds[b])
        out.append(joined[start:end])
        start = end
    return out


class GreedyDecoder(Decoder):
    def __init__(self, labels: str, blank_index: int = 0):
        super().__init__(labels, blank_index)

    def decode(self, probs, sizes=None):
        """Argmax decode of (B, T, C) probabilities (a numpy array or a
        torch tensor on any device).

        Returns (strings, offsets) in the original nested-list layout:
        strings[b] is a one-element list (single path), offsets likewise.
        """
        if isinstance(probs, torch.Tensor):
            # argmax where the tensor lives; only the (B, T) paths move
            max_probs = probs.argmax(dim=2).cpu().numpy()
        else:
            max_probs = np.asarray(probs).argmax(axis=2)
        batch = max_probs.shape[0]
        strings, offsets = [], []
        for b in range(batch):
            size = int(sizes[b]) if sizes is not None else max_probs.shape[1]
            s, off = collapse_sequence(
                max_probs[b], size, self.labels, self.blank_index
            )
            strings.append([s])
            offsets.append([off])
        return strings, offsets
