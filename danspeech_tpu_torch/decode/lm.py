"""N-gram language models for beam-search rescoring.

Replaces the reference's KenLM dependency (SURVEY §2.2 N3): the zoo ships
Kneser-Ney .klm binaries consumed through the C++ ctcdecode extension
(decoder.py:96-100). Here:

- :class:`NgramLM` — a backoff n-gram model with ctcdecode-compatible
  scoring semantics (natural-log conditional probabilities scored from a
  null context, OOV words at -1000, SURVEY §2.2 N2/N3);
- ARPA text loading (`.arpa`, the interchange format every KenLM model
  originates from);
- KenLM *probing* binary loading (`.klm`) via
  :mod:`.kenlm_reader` (and trie binaries via :mod:`.kenlm_trie`);
- a packed numpy representation (open-addressing hash table of fingerprint
  -> (prob, backoff)) shared with the native C++ decoder.

A copy of ``danspeech_tpu.decode.lm``; ``coerce_device_lm`` packs for the
port's own ``device_lm`` on an explicit torch device.
"""

from __future__ import annotations

import gzip
import math

import numpy as np

LOG10 = math.log(10.0)
OOV_SCORE = -1000.0  # natural log; parlance/ctcdecode scorer semantics

# Multiplicative fingerprint chain for n-gram keys in the packed table.
_MIX_A = 0x9E3779B97F4A7C15
_MIX_B = 0xC2B2AE3D27D4EB4F
_MASK64 = (1 << 64) - 1


class NgramLM:
    """Backoff n-gram model over word ids.

    Stores natural-log prob/backoff per n-gram. ``score_word(context, word)``
    returns ln p(word | context) with standard backoff recursion:
    p(w|c) = prob[c+w] if present else backoff[c] + p(w | c[1:]).
    """

    def __init__(self, order: int):
        self.order = order
        self.vocab: dict[str, int] = {}
        self.words: list[str] = []
        # per-order dict: tuple(word_ids) -> (logprob, backoff) in natural log
        self.tables: list[dict[tuple, tuple]] = [dict() for _ in range(order)]

    # -- construction -------------------------------------------------------

    def add_word(self, word: str) -> int:
        idx = self.vocab.get(word)
        if idx is None:
            idx = len(self.words)
            self.vocab[word] = idx
            self.words.append(word)
        return idx

    def add_ngram(self, words: tuple[str, ...], logprob10: float, backoff10: float = 0.0):
        ids = tuple(self.add_word(w) for w in words)
        self.tables[len(ids) - 1][ids] = (logprob10 * LOG10, backoff10 * LOG10)

    # -- scoring ------------------------------------------------------------

    def word_id(self, word: str):
        return self.vocab.get(word)

    def score_word_ids(self, context: tuple, word_id: int) -> float:
        """ln p(word | context); context is a tuple of word ids (oldest
        first), truncated to order-1."""
        context = context[-(self.order - 1) :] if self.order > 1 else ()
        backoff_sum = 0.0
        while True:
            ng = (*context, word_id)
            hit = self.tables[len(ng) - 1].get(ng)
            if hit is not None:
                return backoff_sum + hit[0]
            if not context:
                # unigram miss = OOV
                return OOV_SCORE
            # back off: accumulate backoff weights of the contexts we drop
            bo = self.tables[len(context) - 1].get(context)
            if bo is not None:
                backoff_sum += bo[1]
            context = context[1:]

    def score_word(self, context_words: list[str], word: str) -> float:
        """ctcdecode-compatible word scoring: OOV -> -1000, else backoff
        query with the available (possibly shorter) context."""
        wid = self.vocab.get(word)
        if wid is None:
            return OOV_SCORE
        ctx = tuple(
            self.vocab[w] for w in context_words[-(self.order - 1) :] if w in self.vocab
        )
        return self.score_word_ids(ctx, wid)

    def num_ngrams(self) -> list[int]:
        return [len(t) for t in self.tables]


# ---------------------------------------------------------------------------
# ARPA loading
# ---------------------------------------------------------------------------


def load_arpa(path: str) -> NgramLM:
    """Parse an ARPA n-gram file (optionally gzipped) into an NgramLM."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8", errors="replace") as f:
        # header
        counts = []
        for line in f:
            line = line.strip()
            if line == "\\data\\":
                break
        for line in f:
            line = line.strip()
            if not line:
                break
            if line.startswith("ngram"):
                counts.append(int(line.split("=")[1]))
        order = len(counts)
        lm = NgramLM(order)

        current_order = 0
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line == "\\end\\":
                break
            if line.startswith("\\") and line.endswith("-grams:"):
                current_order = int(line[1 : line.index("-")])
                continue
            parts = line.split("\t")
            if len(parts) < 2:
                parts = line.split()
                if len(parts) < current_order + 1:
                    continue
                logprob = float(parts[0])
                words = tuple(parts[1 : 1 + current_order])
                backoff = (
                    float(parts[1 + current_order])
                    if len(parts) > 1 + current_order
                    else 0.0
                )
            else:
                logprob = float(parts[0])
                words = tuple(parts[1].split())
                backoff = float(parts[2]) if len(parts) > 2 else 0.0
            lm.add_ngram(words, logprob, backoff)
    return lm


def load_lm(path: str) -> NgramLM:
    """Load an LM by extension: .arpa(.gz) text or .klm/.bin KenLM binary
    (probing or trie data structure, auto-detected from the header)."""
    p = str(path)
    if p.endswith((".arpa", ".arpa.gz", ".lm", ".lm.gz")):
        return load_arpa(p)
    with open(p, "rb") as f:
        header = f.read(100)
    if header.startswith(b"mmap"):
        # FixedWidthParameters.model_type at sanity(88) + 8
        model_type = int.from_bytes(header[96:100], "little") if len(header) >= 100 else 0
        if model_type == 0:  # PROBING
            from .kenlm_reader import load_kenlm_probing

            return load_kenlm_probing(p)
        from .kenlm_trie import load_kenlm_trie

        return load_kenlm_trie(p)
    # fall back to ARPA (files without extension)
    return load_arpa(p)


def coerce_device_lm(lm, labels, device=None):
    """Resolve any LM spec (path / NgramLM / trie model / DeviceLM) to a
    DeviceLM (hash tables on ``device``; ``None`` means CUDA), or raise a
    clear ValueError.

    The one coercion chain shared by the engine and the device beam
    decoder. KenLM probing binaries cannot be re-keyed for the device
    scheme (their stored keys are hashes, the word-id tuples are
    unrecoverable), so they get the actionable error instead of an
    AttributeError deep in pack_device_lm.
    """
    if lm is None:
        return None
    from .device_lm import DeviceLM, pack_device_lm

    if isinstance(lm, str):
        lm = load_lm(lm)
    if isinstance(lm, DeviceLM):
        return lm.to(device)
    if hasattr(lm, "to_ngram_lm"):  # trie .klm binaries are walkable
        lm = lm.to_ngram_lm()
    if isinstance(lm, NgramLM):
        return pack_device_lm(lm, labels, device=device)
    raise ValueError(
        f"LM of type {type(lm).__name__} cannot be packed for the "
        "device backend (needs an enumerable NgramLM, e.g. from an "
        ".arpa file); use backend='host' for probing-format KenLM "
        ".klm binaries."
    )


# ---------------------------------------------------------------------------
# Packed table (shared with the C++ decoder / device scoring)
# ---------------------------------------------------------------------------


def _fingerprint(ids: tuple) -> np.uint64:
    h = 0xCBF29CE484222325
    for w in ids:
        h = ((h ^ (((w + 1) * _MIX_B) & _MASK64)) * _MIX_A) & _MASK64
    # avoid the empty-slot sentinel
    return np.uint64(h if h != 0 else 1)


class PackedNgramLM:
    """Open-addressing fingerprint hash table of all n-grams.

    Layout: keys (uint64), probs (float32 ln), backoffs (float32 ln), with
    linear probing at 1.5x load headroom. The same buffers back the native
    C++ scorer.
    Fingerprint collisions across distinct n-grams are possible in principle
    (2^64 space) but negligible at zoo-LM sizes.
    """

    def __init__(self, lm: NgramLM):
        self.order = lm.order
        self.words = list(lm.words)
        self.vocab = dict(lm.vocab)
        n = sum(lm.num_ngrams())
        self.size = max(8, int(n * 1.5))
        self.keys = np.zeros(self.size, dtype=np.uint64)
        self.probs = np.zeros(self.size, dtype=np.float32)
        self.backoffs = np.zeros(self.size, dtype=np.float32)
        for table in lm.tables:
            for ids, (prob, backoff) in table.items():
                self._insert(_fingerprint(ids), prob, backoff)

    def _insert(self, key: np.uint64, prob: float, backoff: float):
        i = int(key % np.uint64(self.size))
        while self.keys[i] != 0 and self.keys[i] != key:
            i = (i + 1) % self.size
        self.keys[i] = key
        self.probs[i] = prob
        self.backoffs[i] = backoff

    def lookup(self, ids: tuple):
        key = _fingerprint(ids)
        i = int(key % np.uint64(self.size))
        while True:
            k = self.keys[i]
            if k == 0:
                return None
            if k == key:
                return float(self.probs[i]), float(self.backoffs[i])
            i = (i + 1) % self.size

    def score_word_ids(self, context: tuple, word_id: int) -> float:
        context = context[-(self.order - 1) :] if self.order > 1 else ()
        score = 0.0
        while True:
            hit = self.lookup((*context, word_id))
            if hit is not None:
                return score + hit[0]
            if not context:
                return OOV_SCORE
            bo = self.lookup(context)
            score += bo[1] if bo is not None else 0.0
            context = context[1:]

    def score_word(self, context_words: list[str], word: str) -> float:
        wid = self.vocab.get(word)
        if wid is None:
            return OOV_SCORE
        ctx = tuple(
            self.vocab[w]
            for w in context_words[-(self.order - 1) :]
            if w in self.vocab
        )
        return self.score_word_ids(ctx, wid)
