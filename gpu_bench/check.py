"""The comparison that decides ``correct``: each sampled served transcript
against the plain reference's logits.

A greedy CTC transcript is the collapse of one path of labels, one label a
frame. The served text does not say which path the program took, so the
comparison takes the path that the text allows and that lies closest to
the reference: over every CTC alignment of the text, the least of the widest
gap by which the path's label at a frame lies below the reference's best
logit at that frame. The text equal to the reference's own greedy text reads
0; a text that no alignment of the utterance's frames can spell reads
infinity.
"""

from __future__ import annotations

import numpy as np


def text_gap(logits: np.ndarray, text: str, labels: str, blank: int = 0) -> float:
    """The widest gap (in logits) of the best CTC alignment of ``text`` over
    the reference's (T, classes) ``logits``."""
    logits = np.asarray(logits, dtype=np.float64)
    gap = logits.max(axis=1, keepdims=True) - logits  # (T, C) >= 0
    t_max = gap.shape[0]
    index = {c: i for i, c in enumerate(labels)}
    if any(c not in index for c in text):
        return float("inf")
    ids = [index[c] for c in text]
    ext = np.full(2 * len(ids) + 1, blank, dtype=np.int64)
    ext[1::2] = ids
    s_len = len(ext)
    # a label may follow the one two states back unless it is a blank or
    # repeats that label (then the blank between them is required)
    skip = np.zeros(s_len, dtype=bool)
    skip[2:] = (ext[2:] != blank) & (ext[2:] != ext[:-2])
    best = np.full(s_len, np.inf)
    best[0] = gap[0, ext[0]]
    if s_len > 1:
        best[1] = gap[0, ext[1]]
    for t in range(1, t_max):
        prev = best.copy()
        prev[1:] = np.minimum(prev[1:], best[:-1])
        prev[2:] = np.where(skip[2:], np.minimum(prev[2:], best[:-2]), prev[2:])
        best = np.maximum(prev, gap[t, ext])
    if s_len == 1:
        return float(best[0])
    return float(min(best[-1], best[-2]))


def greedy_text(logits: np.ndarray, labels: str, blank: int = 0) -> str:
    """The greedy CTC collapse of ``logits``: argmax a frame, repeats merged,
    blanks dropped."""
    path = np.asarray(logits).argmax(axis=1)
    keep = (path != blank) & (path != np.concatenate(([blank], path[:-1])))
    return "".join(labels[i] for i in path[keep])


def frame_gap(logits: np.ndarray, chosen: np.ndarray) -> float:
    """The widest gap, over frames, of the label ``chosen`` a frame below the
    reference's best."""
    logits = np.asarray(logits, dtype=np.float64)
    picked = logits[np.arange(len(chosen)), chosen]
    return float((logits.max(axis=1) - picked).max())


def sample_requests(finished: list, lengths: dict, seed: int, count: int) -> list:
    """``count`` of the ``finished`` requests, (call number, utterance)
    pairs in the order they finished, drawn from ``seed``; ``lengths`` maps
    an utterance to its sample count. The first request of the longest
    utterance is always among them."""
    if not finished:
        return []
    rng = np.random.default_rng([seed, 0x5EED])
    longest = max(finished, key=lambda r: lengths[r[1]])
    rest = [r for r in finished if r != longest]
    take = rng.choice(len(rest), size=min(count - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(take)]
