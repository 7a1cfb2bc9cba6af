"""WER/CER metrics with a numpy edit distance (host-side, not on the hot
path). A copy of ``danspeech_tpu.decode.metrics``."""

from __future__ import annotations

import numpy as np


def levenshtein(a, b) -> int:
    """Edit distance between two sequences (vectorized row DP).

    The in-row insert cascade cur[j] = min(m[j], cur[j-1]+1) is computed in
    closed form as j + cummin(m - j), keeping each row O(|b|) numpy work.
    """
    if len(a) == 0:
        return len(b)
    if len(b) == 0:
        return len(a)
    if isinstance(b, str):
        b_arr = np.array([ord(c) for c in b], dtype=np.int64)
    else:
        b_arr = np.asarray(b, dtype=np.int64)
    j_idx = np.arange(1, len(b_arr) + 1)
    prev = np.arange(len(b_arr) + 1)
    for i, ca in enumerate(a, start=1):
        code = ord(ca) if isinstance(ca, str) else ca
        sub = prev[:-1] + (b_arr != code)
        m = np.minimum(prev[1:] + 1, sub)
        m = np.minimum(m, i + j_idx)  # account for cur[0] = i as cascade seed
        cur = np.empty_like(prev)
        cur[0] = i
        cur[1:] = j_idx + np.minimum.accumulate(m - j_idx)
        prev = cur
    return int(prev[-1])


def wer(s1: str, s2: str) -> int:
    """Word-level edit distance. Like the original danspeech, this returns
    the raw distance, not a rate — callers normalize by reference length."""
    vocab = set(s1.split() + s2.split())
    word2idx = {w: i for i, w in enumerate(vocab)}
    w1 = [word2idx[w] for w in s1.split()]
    w2 = [word2idx[w] for w in s2.split()]
    return levenshtein(w1, w2)


def cer(s1: str, s2: str) -> int:
    """Character-level edit distance ignoring spaces."""
    return levenshtein(s1.replace(" ", ""), s2.replace(" ", ""))
