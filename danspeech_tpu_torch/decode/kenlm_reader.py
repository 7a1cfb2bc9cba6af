"""KenLM *probing* binary format (.klm) reader and writer.

The reference's LM zoo ships KenLM binaries (reference
danspeech/language_models/*.py, e.g. dsl_3gram.py:7-20) consumed by the
ctcdecode C++ extension through libkenlm. This module reads that format
directly — no kenlm dependency — into :class:`KenLMProbingModel`, which
scores with the same API as :class:`.lm.NgramLM`.

Format (kenlm lm/binary_format.cc, version 5, PROBING model type):

    [Sanity]            88 B: magic string + endianness reference values
    [FixedWidthParams]  20 B: order, probing multiplier, model type,
                              has_vocabulary, search version
    [counts]            8 B x order (n-gram counts per order)
    (pad to 8)
    [ProbingVocabularyHeader] 8 B: version, bound (vocab size incl <unk>)
    [vocab hash table]  open-addressing, entry = (u64 murmur(word), u32 id),
                        12 B packed; buckets = max(n+1, mult*n)
    [unigram array]     (counts[0]+1) x (f32 prob, f32 backoff), indexed by id
    [middle tables]     per order 2..N-1: entry = (u64 key, f32, f32), 16 B
    [longest table]     entry = (u64 key, f32 prob), 12 B
    [vocab strings]     '\0'-separated words in id order (id 0 = <unk>)

N-gram keys are hash chains (lm/search_hashed.hh): for (w1..wn) the key is
fold(CombineWordHash, start=id(wn), ids of w_{n-1}..w1), where
CombineWordHash(h, w) = (h * 8978948897894561157) ^ ((1+w) * 17894857484156487943).
Probs/backoffs are log10 in the file; converted to natural log on load to
match NgramLM scoring semantics.

A hash-table binary stores no explicit word tuples, so a .klm cannot be
converted back to dict-of-tuples form; KenLMProbingModel instead scores
straight off the mmap'd tables, exactly like kenlm's ProbingModel.

A copy of ``danspeech_tpu.decode.kenlm_reader``.
"""

from __future__ import annotations

import math

import numpy as np

from .lm import LOG10, OOV_SCORE, NgramLM

MAGIC = b"mmap lm http://kheafield.com/code format version 5\n\0"
MAGIC_PREFIX = b"mmap lm http://kheafield.com/code format version"

_SANITY_SIZE = 88  # align8(53) magic + 3 floats + 2 u32 + pad + u64
_MAGIC_FIELD = 56

_COMBINE_A = 8978948897894561157
_COMBINE_B = 17894857484156487943
_MASK64 = (1 << 64) - 1

MODEL_PROBING = 0

_UNK = "<unk>"


def _align8(x: int) -> int:
    return (x + 7) & ~7


def murmur_hash64a(data: bytes, seed: int = 0) -> int:
    """MurmurHash64A — kenlm's util::MurmurHashNative on LE x86-64 hosts
    (util/murmur_hash.cc). Used for vocabulary word hashing."""
    m = 0xC6A4A7935BD1E995
    r = 47
    h = (seed ^ ((len(data) * m) & _MASK64)) & _MASK64
    n8 = len(data) & ~7
    for i in range(0, n8, 8):
        k = int.from_bytes(data[i : i + 8], "little")
        k = (k * m) & _MASK64
        k ^= k >> r
        k = (k * m) & _MASK64
        h ^= k
        h = (h * m) & _MASK64
    tail = data[n8:]
    if tail:
        h ^= int.from_bytes(tail, "little")
        h = (h * m) & _MASK64
    h ^= h >> r
    h = (h * m) & _MASK64
    h ^= h >> r
    return h


def _combine(h: int, word_id: int) -> int:
    return ((h * _COMBINE_A) & _MASK64) ^ (((1 + word_id) * _COMBINE_B) & _MASK64)


def ngram_hash(ids_oldest_first) -> int:
    """Chained key for an n-gram given word ids oldest-first."""
    ids = list(ids_oldest_first)
    h = ids[-1]  # newest word starts the chain
    for w in reversed(ids[:-1]):
        h = _combine(h, w)
    return h


def _buckets(entries: int, multiplier: float) -> int:
    # util::ProbingHashTable::Size — float multiply then truncate
    return max(entries + 1, int(np.float32(multiplier) * np.float32(entries)))


class _ProbingTable:
    """Open-addressing numpy view: parallel (keys u64, values float32 pairs)."""

    def __init__(self, keys: np.ndarray, probs: np.ndarray, backoffs):
        self.keys = keys
        self.probs = probs
        self.backoffs = backoffs  # None for the longest order
        self.n = len(keys)

    def lookup(self, key: int):
        if self.n == 0:
            return None
        i = key % self.n
        keys = self.keys
        while True:
            k = int(keys[i])
            if k == key:
                return (
                    float(self.probs[i]),
                    float(self.backoffs[i]) if self.backoffs is not None else 0.0,
                )
            if k == 0:
                return None
            i += 1
            if i == self.n:
                i = 0


class KenLMProbingModel:
    """Scores words off the probing hash tables, kenlm-style.

    API-compatible subset of NgramLM: ``order``, ``vocab``, ``words``,
    ``word_id``, ``score_word_ids``, ``score_word``, ``num_ngrams``.
    Probabilities are natural-log (converted from the file's log10).
    """

    def __init__(
        self, order, counts, vocab, words, unigram, middles, longest,
        vocab_hash=None,
    ):
        self.order = order
        self.counts = counts
        self.vocab = vocab  # word -> id
        self.words = words  # id -> word
        self._unigram = unigram  # (counts[0]+1, 2) float64, natural log
        self._middles = middles  # list of _ProbingTable for orders 2..N-1
        self._longest = longest  # _ProbingTable (backoffs=None)
        self._vocab_hash = vocab_hash  # (murmur keys u64, ids u32) on-file table
        self._unk_id = 0

    def word_id(self, word: str):
        return self.vocab.get(word)

    def num_ngrams(self):
        return list(self.counts)

    def _table(self, order_n: int) -> _ProbingTable:
        return self._middles[order_n - 2] if order_n < self.order else self._longest

    def score_word_ids(self, context: tuple, word_id: int) -> float:
        """ln p(word | context); context ids oldest-first, like NgramLM."""
        context = context[-(self.order - 1) :] if self.order > 1 else ()
        prob = float(self._unigram[word_id, 0])
        matched = 1
        h = word_id
        # extend the match newest-context-word first
        for i, c in enumerate(reversed(context)):
            h = _combine(h, c)
            hit = self._table(i + 2).lookup(h)
            if hit is None:
                break
            prob = hit[0]
            matched = i + 2
        # add backoff of every context suffix longer than the matched one
        score = prob
        for k in range(matched - 1, len(context)):
            # context suffix of length k+1: last k+1 context words
            if k == 0:
                score += float(self._unigram[context[-1], 1])
            else:
                hit = self._table(k + 1).lookup(ngram_hash(context[-(k + 1) :]))
                if hit is not None:
                    score += hit[1]
        return score

    def score_word(self, context_words, word: str) -> float:
        wid = self.vocab.get(word)
        if wid is None or wid == self._unk_id:
            return OOV_SCORE
        ctx = tuple(
            self.vocab[w]
            for w in context_words[-(self.order - 1) :]
            if w in self.vocab
        )
        return self.score_word_ids(ctx, wid)


def load_kenlm_probing(path: str) -> KenLMProbingModel:
    with open(path, "rb") as f:
        data = f.read()
    return parse_kenlm_probing(data)


def parse_kenlm_probing(data: bytes) -> KenLMProbingModel:
    if not data.startswith(MAGIC_PREFIX):
        raise ValueError("Not a KenLM binary (bad magic)")
    if not data.startswith(MAGIC):
        version = data[len(MAGIC_PREFIX) : len(MAGIC_PREFIX) + 4].split(b"\n")[0]
        raise ValueError(
            f"Unsupported KenLM binary format version{version.decode(errors='replace')}"
            " (only version 5 is supported)"
        )
    if len(data) < _SANITY_SIZE + 28:
        raise ValueError("Truncated KenLM binary (header incomplete)")

    order = data[_SANITY_SIZE]
    multiplier = float(np.frombuffer(data, np.float32, 1, _SANITY_SIZE + 4)[0])
    model_type = int(np.frombuffer(data, np.int32, 1, _SANITY_SIZE + 8)[0])
    has_vocab = data[_SANITY_SIZE + 12] != 0
    if model_type != MODEL_PROBING:
        raise ValueError(
            f"KenLM model type {model_type} is not a probing binary — "
            "trie binaries load via decode.kenlm_trie.load_kenlm_trie "
            "(decode.lm.load_lm dispatches automatically)"
        )
    counts = [
        int(c)
        for c in np.frombuffer(data, np.uint64, order, _SANITY_SIZE + 20)
    ]
    off = _align8(_SANITY_SIZE + 20 + 8 * order)

    # size check up front: every fixed-width section must fit
    vb_chk = _buckets(counts[0], multiplier)
    need = off + 8 + vb_chk * 12 + (counts[0] + 1) * 8
    for n in range(2, order):
        need += _buckets(counts[n - 1], multiplier) * 16
    if order > 1:
        need += _buckets(counts[order - 1], multiplier) * 12
    if len(data) < need:
        raise ValueError(
            f"Truncated KenLM binary: {len(data)} bytes, need {need}"
        )

    # -- vocabulary ---------------------------------------------------------
    bound = int(np.frombuffer(data, np.uint32, 1, off + 4)[0])
    off += 8
    vb = _buckets(counts[0], multiplier)
    vocab_raw = np.frombuffer(data, np.uint8, vb * 12, off).reshape(vb, 12)
    vocab_keys = vocab_raw[:, :8].copy().view(np.uint64).ravel()
    vocab_ids = vocab_raw[:, 8:].copy().view(np.uint32).ravel()
    off += vb * 12

    # -- unigram ------------------------------------------------------------
    n_uni = counts[0] + 1
    unigram = (
        np.frombuffer(data, np.float32, n_uni * 2, off)
        .reshape(n_uni, 2)
        .astype(np.float64)
        * LOG10
    )
    off += n_uni * 8

    # -- middle + longest tables -------------------------------------------
    middles = []
    for n in range(2, order):
        nb = _buckets(counts[n - 1], multiplier)
        raw = np.frombuffer(data, np.uint8, nb * 16, off).reshape(nb, 16)
        keys = raw[:, :8].copy().view(np.uint64).ravel()
        vals = raw[:, 8:].copy().view(np.float32).reshape(nb, 2) * np.float32(LOG10)
        middles.append(_ProbingTable(keys, vals[:, 0], vals[:, 1]))
        off += nb * 16
    lb = _buckets(counts[order - 1], multiplier) if order > 1 else 0
    raw = np.frombuffer(data, np.uint8, lb * 12, off).reshape(lb, 12)
    longest = _ProbingTable(
        raw[:, :8].copy().view(np.uint64).ravel(),
        raw[:, 8:].copy().view(np.float32).ravel() * np.float32(LOG10),
        None,
    )
    off += lb * 12

    # -- vocab strings ------------------------------------------------------
    words: list[str] = []
    vocab: dict[str, int] = {}
    if has_vocab and off < len(data):
        raw_words = data[off:].split(b"\0")
        words = [w.decode("utf-8", errors="replace") for w in raw_words if w]
        if len(words) > bound:
            words = words[:bound]
        vocab = {w: i for i, w in enumerate(words)}
    else:
        # no embedded strings: resolve ids through the murmur hash table
        # lazily via hash probes — expose a hash-backed vocab dict.
        vocab = _HashVocab(vocab_keys, vocab_ids)

    return KenLMProbingModel(
        order, counts, vocab, words, unigram, middles, longest,
        vocab_hash=(vocab_keys, vocab_ids),
    )


class _HashVocab(dict):
    """word -> id via the on-file murmur hash table (files without strings)."""

    def __init__(self, keys: np.ndarray, ids: np.ndarray):
        super().__init__()
        self._keys = keys
        self._ids = ids
        self._n = len(keys)

    def get(self, word, default=None):
        if word in (_UNK, "<UNK>"):
            return 0
        h = murmur_hash64a(word.encode("utf-8"))
        i = h % self._n
        while True:
            k = int(self._keys[i])
            if k == h:
                return int(self._ids[i])
            if k == 0:
                return default
            i += 1
            if i == self._n:
                i = 0

    def __contains__(self, word):
        return self.get(word) is not None

    def __getitem__(self, word):
        # dict.__getitem__ would consult the (empty) underlying dict —
        # score_word's `vocab[w]` must probe the hash table like get()
        v = self.get(word)
        if v is None:
            raise KeyError(word)
        return v


# ---------------------------------------------------------------------------
# Writer — ARPA/NgramLM -> .klm probing binary
# ---------------------------------------------------------------------------


def write_kenlm_probing(
    lm: NgramLM, path: str, probing_multiplier: float = 1.5
) -> None:
    """Serialize an NgramLM to the KenLM probing binary layout above.

    Functions as the `build_binary probing` equivalent for our stack and as
    the round-trip oracle for the reader (kenlm's own tools are not a
    dependency, so the tests make their fixtures with this writer).
    """
    order = lm.order
    # binary word ids: <unk> = 0, all other words follow in NgramLM id order
    remap: dict[int, int] = {}
    words_out = [_UNK]
    for wid, w in enumerate(lm.words):
        if w == _UNK:
            remap[wid] = 0
        else:
            remap[wid] = len(words_out)
            words_out.append(w)
    n_vocab = len(words_out)

    counts = list(lm.num_ngrams())
    counts[0] = n_vocab  # kenlm: one unigram slot per vocab word

    buf = bytearray()
    # Sanity
    sanity = bytearray(_SANITY_SIZE)
    sanity[: len(MAGIC)] = MAGIC
    sanity[_MAGIC_FIELD : _MAGIC_FIELD + 12] = np.array(
        [0.0, 1.0, -0.5], np.float32
    ).tobytes()
    sanity[68:76] = np.array([1, 0xFFFFFFFF], np.uint32).tobytes()
    sanity[80:88] = np.array([1], np.uint64).tobytes()
    buf += sanity
    # FixedWidthParameters + counts
    params = bytearray(20)
    params[0] = order
    params[4:8] = np.float32(probing_multiplier).tobytes()
    params[8:12] = np.int32(MODEL_PROBING).tobytes()
    params[12] = 1  # has_vocabulary
    params[16:20] = np.uint32(0).tobytes()  # search version
    buf += params
    buf += np.array(counts, np.uint64).tobytes()
    buf += b"\0" * (_align8(len(buf)) - len(buf))

    # vocab header + hash table (murmur(word) -> id; <unk> not inserted)
    buf += np.array([0, n_vocab], np.uint32).tobytes()
    vb = _buckets(counts[0], probing_multiplier)
    vkeys = np.zeros(vb, np.uint64)
    vids = np.zeros(vb, np.uint32)
    for bid, w in enumerate(words_out):
        if bid == 0:
            continue
        h = murmur_hash64a(w.encode("utf-8"))
        i = h % vb
        while vkeys[i] != 0:
            i = (i + 1) % vb
        vkeys[i] = h
        vids[i] = bid
    ventries = np.zeros((vb, 12), np.uint8)
    ventries[:, :8] = vkeys.view(np.uint8).reshape(vb, 8)
    ventries[:, 8:] = vids.view(np.uint8).reshape(vb, 4)
    buf += ventries.tobytes()

    # unigram array (log10)
    uni = np.zeros((counts[0] + 1, 2), np.float32)
    uni[0, 0] = -100.0  # kenlm's unknown_missing default
    for ids, (p, b) in lm.tables[0].items():
        uni[remap[ids[0]], 0] = p / LOG10
        uni[remap[ids[0]], 1] = b / LOG10
    buf += uni.tobytes()

    # middle tables
    for n in range(2, order):
        nb = _buckets(counts[n - 1], probing_multiplier)
        keys = np.zeros(nb, np.uint64)
        vals = np.zeros((nb, 2), np.float32)
        for ids, (p, b) in lm.tables[n - 1].items():
            h = ngram_hash([remap[i] for i in ids])
            i = h % nb
            while keys[i] != 0:
                i = (i + 1) % nb
            keys[i] = h
            vals[i] = (p / LOG10, b / LOG10)
        entries = np.zeros((nb, 16), np.uint8)
        entries[:, :8] = keys.view(np.uint8).reshape(nb, 8)
        entries[:, 8:] = vals.view(np.uint8).reshape(nb, 8)
        buf += entries.tobytes()

    # longest table
    if order > 1:
        nb = _buckets(counts[order - 1], probing_multiplier)
        keys = np.zeros(nb, np.uint64)
        vals = np.zeros(nb, np.float32)
        for ids, (p, _b) in lm.tables[order - 1].items():
            h = ngram_hash([remap[i] for i in ids])
            i = h % nb
            while keys[i] != 0:
                i = (i + 1) % nb
            keys[i] = h
            vals[i] = p / LOG10
        entries = np.zeros((nb, 12), np.uint8)
        entries[:, :8] = keys.view(np.uint8).reshape(nb, 8)
        entries[:, 8:] = vals.view(np.uint8).reshape(nb, 4)
        buf += entries.tobytes()

    # vocab strings, id order
    for w in words_out:
        buf += w.encode("utf-8") + b"\0"

    with open(path, "wb") as f:
        f.write(bytes(buf))
