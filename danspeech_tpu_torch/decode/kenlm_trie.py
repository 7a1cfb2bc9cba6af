"""KenLM *trie* binary format (.klm) reader and writer.

KenLM's ``build_binary`` default is the trie data structure, so zoo
binaries (reference danspeech/language_models/*.py) may be trie-built
rather than probing-built; kenlm_reader.py reads only probing files.
This module implements the TRIE layout in all four
shipped variants (kenlm lm/trie.hh, lm/trie.cc, lm/quantize.hh,
lm/bhiksha.hh, util/bit_packing.hh; format version 5):

    model type 2  TRIE               (plain)
    model type 3  QUANT_TRIE         (build_binary -q/-b)
    model type 4  ARRAY_TRIE         (build_binary -a)
    model type 5  QUANT_ARRAY_TRIE   (-q -a)

Layout:

    [Sanity + FixedWidthParams + counts]  shared with probing (kenlm_reader)
    [SortedVocabulary]   u64 entry count, then sorted u64 murmur hashes of
                         every word except <unk>; word id = 1 + rank, id 0
                         is <unk> (lm/vocab.cc SortedVocabulary)
    [Quant tables]       (quantized only, lm/quantize.cc SeparatelyQuantize)
                         8-byte header [u8 prob_bits][u8 backoff_bits][pad],
                         then per middle order 2..N-1 a prob-center table
                         (2^prob_bits f32) + backoff-center table
                         (2^backoff_bits f32), then the longest order's
                         prob-center table. Backoff bins 0/1 are reserved
                         for 0.0 (no-extension) and -0.0 (extension).
    [Unigram]            (counts[0] + 2) x { f32 prob, f32 backoff,
                         u64 next } — never quantized; next indexes the
                         first child in the order-2 array; the extra tail
                         entries carry the end pointer (lm/trie.hh)
    [BitPackedMiddle]    per order 2..N-1: if Bhiksha, first an 8-byte
                         header [u8 version=0][u8 pointer_bhiksha_bits] and
                         the u64 offset array ((max_next >> inline)+1
                         entries, lm/bhiksha.hh ArrayBhiksha); then
                         (entries+1) records of [word RequiredBits(counts[0])]
                         [prob 31 bits sign-dropped | prob_bits bin]
                         [backoff f32 | backoff_bits bin]
                         [next: RequiredBits(next_entries) or the Bhiksha
                         inline low bits] packed LSB-first into
                         little-endian bytes, + 8 slack bytes
    [BitPackedLongest]   records of [word bits][prob 31 | prob_bits bin]
                         + 8 slack bytes
    [vocab strings]      optional '\\0'-separated words in id order

The trie branches on the *predicted* word first, then context words going
backwards: the n-gram (c1 .. c_{n-1}, w) lives on the path
w -> c_{n-1} -> ... -> c1, each level's children sorted by word id so
lookups binary-search the parent's [next, next_end) range.

Bhiksha compression (Bhiksha & Harb): next pointers are monotone in the
record index, so each record stores only the low ``inline`` bits; the
offset array maps a high value h to the first record index whose
next >> inline >= h, recovered at read time by binary search
(lm/bhiksha.hh ReadNext / WriteNext). The inline width replicates kenlm's
ChopBits cost model (bhiksha.cc).

The byte layout is validated by reader/writer round-trip plus scoring
parity against the backoff oracle (tests/test_kenlm_trie.py) for all four
variants, since no kenlm toolchain is a dependency.

A copy of ``danspeech_tpu.decode.kenlm_trie``.
"""

from __future__ import annotations

import numpy as np

from .kenlm_reader import (
    MAGIC,
    MAGIC_PREFIX,
    _SANITY_SIZE,
    _MAGIC_FIELD,
    _align8,
    murmur_hash64a,
)
from .lm import LOG10, OOV_SCORE, NgramLM

MODEL_TRIE = 2
MODEL_QUANT_TRIE = 3
MODEL_ARRAY_TRIE = 4
MODEL_QUANT_ARRAY_TRIE = 5

_UNK = "<unk>"
_SIGN_BIT = np.uint32(0x80000000)


def required_bits(max_value: int) -> int:
    """util::RequiredBits — bits needed to hold max_value itself."""
    if not max_value:
        return 0
    ret = 1
    while max_value := max_value >> 1:
        ret += 1
    return ret


# ---------------------------------------------------------------------------
# LSB-first bit packing over little-endian bytes (util/bit_packing.hh)
# ---------------------------------------------------------------------------


class _BitWriter:
    def __init__(self, n_bits: int):
        # +8 slack bytes so 64-bit reads at any offset stay in bounds
        self.buf = bytearray((n_bits + 7) // 8 + 8)

    def write(self, bit_off: int, length: int, value: int):
        byte = bit_off >> 3
        shift = bit_off & 7
        cur = int.from_bytes(self.buf[byte : byte + 8], "little")
        cur |= (value & ((1 << length) - 1)) << shift
        self.buf[byte : byte + 8] = cur.to_bytes(8, "little")


def _bit_read(buf, bit_off: int, length: int) -> int:
    byte = bit_off >> 3
    word = int.from_bytes(buf[byte : byte + 8], "little")
    return (word >> (bit_off & 7)) & ((1 << length) - 1)


def _float_to_31(value_log10: float) -> int:
    """WriteNonPositiveFloat31: float bits with the sign bit dropped."""
    bits = int(np.float32(value_log10).view(np.uint32))
    return bits & 0x7FFFFFFF


def _float_from_31(bits: int) -> float:
    """ReadNonPositiveFloat31: force the sign bit back on."""
    return float(np.uint32(bits | _SIGN_BIT).view(np.float32))


def _float_to_32(value_log10: float) -> int:
    return int(np.float32(value_log10).view(np.uint32))


def _float_from_32(bits: int) -> float:
    return float(np.uint32(bits).view(np.float32))


# ---------------------------------------------------------------------------
# Quantization (lm/quantize.hh SeparatelyQuantize)
# ---------------------------------------------------------------------------


def _make_bins(values, bins: int) -> np.ndarray:
    """Quantile bin centers over sorted values (lm/quantize.cc MakeBins):
    equal-count slices, center = slice mean. If there are fewer distinct
    values than bins, each gets its own (lossless) center."""
    centers = np.zeros(bins, np.float32)
    v = np.sort(np.asarray(values, np.float32))
    if v.size == 0:
        return centers
    uniq = np.unique(v)
    if uniq.size <= bins:
        centers[: uniq.size] = uniq
        centers[uniq.size :] = uniq[-1]
        return centers
    edges = (v.size * np.arange(bins + 1)) // bins
    for i in range(bins):
        sl = v[edges[i] : edges[i + 1]]
        centers[i] = sl.mean() if sl.size else centers[i - 1]
    return centers


class _Bins:
    """One center table; Encode picks the nearest center via lower_bound
    with ``reserved`` leading slots excluded (lm/quantize.hh Bins)."""

    def __init__(self, centers: np.ndarray):
        self.centers = np.asarray(centers, np.float32)

    def decode(self, idx: int) -> float:
        return float(self.centers[idx])

    def encode(self, value: float, reserved: int) -> int:
        c = self.centers
        above = int(np.searchsorted(c[reserved:], np.float32(value), "left")) + reserved
        if above == reserved:
            return reserved
        if above == len(c):
            return len(c) - 1
        lower, upper = float(c[above - 1]), float(c[above])
        return above - (value - lower < upper - value)

    def encode_prob(self, value: float) -> int:
        return self.encode(value, 0)

    def encode_backoff(self, value: float, has_extension: bool) -> int:
        # bins 0/1 reserved: kNoExtensionBackoff (0.0) / kExtensionBackoff
        # (-0.0), lm/blank.hh
        if value == 0.0:
            return 1 if has_extension else 0
        return self.encode(value, 2)


# ---------------------------------------------------------------------------
# Bhiksha next-pointer compression (lm/bhiksha.hh ArrayBhiksha)
# ---------------------------------------------------------------------------

_BHIKSHA_VERSION = 0


def _chop_bits(max_offset: int, max_next: int, pointer_bhiksha_bits: int) -> int:
    """bhiksha.cc ChopBits: minimize table bits minus inline savings."""
    required = required_bits(max_next)
    best_chop, lowest = 0, None
    for chop in range(0, min(required, pointer_bhiksha_bits) + 1):
        change = (max_next >> (required - chop)) * 64 - max_offset * chop
        if lowest is None or change < lowest:
            lowest, best_chop = change, chop
    return best_chop


def _bhiksha_inline_bits(max_offset, max_next, pointer_bhiksha_bits) -> int:
    return required_bits(max_next) - _chop_bits(
        max_offset, max_next, pointer_bhiksha_bits
    )


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


class _Middle:
    """One bit-packed middle level.

    Record: [word][prob payload][backoff payload][next], where prob/backoff
    are 31/32-bit floats (plain) or quant bin indices, and next is the full
    pointer (plain) or the Bhiksha inline low bits + offset-array highs.
    """

    def __init__(self, buf, entries, word_bits, next_bits,
                 prob_bins: _Bins | None = None,
                 backoff_bins: _Bins | None = None,
                 bhiksha_offsets: np.ndarray | None = None):
        self.buf = buf
        self.entries = entries
        self.word_bits = word_bits
        self.next_bits = next_bits  # inline bits when Bhiksha
        self.prob_bins = prob_bins
        self.backoff_bins = backoff_bins
        self.offsets = bhiksha_offsets
        self.prob_width = 31 if prob_bins is None else len(prob_bins.centers).bit_length() - 1
        self.backoff_width = 32 if backoff_bins is None else len(backoff_bins.centers).bit_length() - 1
        self.total_bits = word_bits + self.prob_width + self.backoff_width + next_bits

    def word_at(self, i: int) -> int:
        return _bit_read(self.buf, i * self.total_bits, self.word_bits)

    def _next_at(self, i: int) -> int:
        low = _bit_read(
            self.buf,
            i * self.total_bits + self.word_bits + self.prob_width + self.backoff_width,
            self.next_bits,
        )
        if self.offsets is None:
            return low
        # lm/bhiksha.hh ReadNext: high bits recovered from the offset array
        high = int(np.searchsorted(self.offsets, i, side="right")) - 1
        return (high << self.next_bits) | low

    def read(self, i: int):
        off = i * self.total_bits
        word = _bit_read(self.buf, off, self.word_bits)
        off += self.word_bits
        if self.prob_bins is None:
            prob = _float_from_31(_bit_read(self.buf, off, 31))
        else:
            prob = self.prob_bins.decode(_bit_read(self.buf, off, self.prob_width))
        off += self.prob_width
        if self.backoff_bins is None:
            backoff = _float_from_32(_bit_read(self.buf, off, 32))
        else:
            backoff = self.backoff_bins.decode(
                _bit_read(self.buf, off, self.backoff_width)
            )
        return word, prob, backoff, self._next_at(i), self._next_at(i + 1)

    def find(self, word: int, begin: int, end: int):
        """Binary search the sorted child range for ``word``."""
        lo, hi = begin, end
        while lo < hi:
            mid = (lo + hi) // 2
            w = self.word_at(mid)
            if w < word:
                lo = mid + 1
            elif w > word:
                hi = mid
            else:
                return mid
        return None


class _Longest:
    def __init__(self, buf, entries, word_bits, prob_bins: _Bins | None = None):
        self.buf = buf
        self.entries = entries
        self.word_bits = word_bits
        self.prob_bins = prob_bins
        self.prob_width = 31 if prob_bins is None else len(prob_bins.centers).bit_length() - 1
        self.total_bits = word_bits + self.prob_width

    def word_at(self, i: int) -> int:
        return _bit_read(self.buf, i * self.total_bits, self.word_bits)

    def read(self, i: int):
        off = i * self.total_bits
        word = _bit_read(self.buf, off, self.word_bits)
        if self.prob_bins is None:
            prob = _float_from_31(_bit_read(self.buf, off + self.word_bits, 31))
        else:
            prob = self.prob_bins.decode(
                _bit_read(self.buf, off + self.word_bits, self.prob_width)
            )
        return word, prob

    find = _Middle.find


class KenLMTrieModel:
    """Scores words off the bit-packed trie, kenlm-style.

    API-compatible subset of NgramLM (like KenLMProbingModel): ``order``,
    ``vocab``, ``words``, ``word_id``, ``score_word_ids``, ``score_word``,
    ``num_ngrams``. Log10 file values are converted to natural log.
    """

    def __init__(self, order, counts, vocab, words, sorted_hashes,
                 unigram, middles, longest):
        self.order = order
        self.counts = counts
        self.vocab = vocab  # word -> id (dict, or hash-backed)
        self.words = words
        self._hashes = sorted_hashes  # sorted u64, ids are 1 + rank
        self._unigram = unigram  # (counts[0]+2, 2) float64 natural log
        self._uni_next = None  # set by loader: (counts[0]+2,) uint64
        self._middles = middles
        self._longest = longest
        self._unk_id = 0

    def word_id(self, word: str):
        if word == _UNK:
            return 0
        h = murmur_hash64a(word.encode("utf-8"))
        i = int(np.searchsorted(self._hashes, np.uint64(h)))
        if i < len(self._hashes) and self._hashes[i] == np.uint64(h):
            return i + 1
        return None

    def num_ngrams(self):
        return list(self.counts)

    def _level(self, order_n: int):
        return (
            self._middles[order_n - 2]
            if order_n < self.order
            else self._longest
        )

    def score_word_ids(self, context: tuple, word_id: int) -> float:
        """ln p(word | context); mirrors KenLMProbingModel.score_word_ids
        (longest-match walk + backoff suffix sum)."""
        context = context[-(self.order - 1):] if self.order > 1 else ()
        prob = float(self._unigram[word_id, 0])
        matched = 1
        begin, end = int(self._uni_next[word_id]), int(self._uni_next[word_id + 1])
        for i, c in enumerate(reversed(context)):
            if begin >= end:
                break
            level = self._level(i + 2)
            hit = level.find(c, begin, end)
            if hit is None:
                break
            if i + 2 < self.order:
                _, p, _b, begin, end = level.read(hit)
            else:
                _, p = level.read(hit)
                begin, end = 0, 0
            prob = p * LOG10
            matched = i + 2
        score = prob
        for k in range(matched - 1, len(context)):
            score += self._context_backoff(context[-(k + 1):])
        return score

    def _context_backoff(self, ctx_ids) -> float:
        """Backoff weight of the context n-gram (natural log, 0 if absent)."""
        n = len(ctx_ids)
        if n == 0:
            return 0.0
        if n == 1:
            return float(self._unigram[ctx_ids[0], 1])
        if n >= self.order:
            return 0.0  # longest order stores no backoff
        # path: last word of the context n-gram first, then backwards
        w = ctx_ids[-1]
        begin, end = int(self._uni_next[w]), int(self._uni_next[w + 1])
        for i, c in enumerate(reversed(ctx_ids[:-1])):
            if begin >= end:
                return 0.0
            level = self._level(i + 2)
            hit = level.find(c, begin, end)
            if hit is None:
                return 0.0
            _, p, b, begin, end = level.read(hit)
            if i == n - 2:
                return b * LOG10
        return 0.0

    def score_word(self, context_words, word: str) -> float:
        wid = self.word_id(word)
        if wid is None or wid == self._unk_id:
            return OOV_SCORE
        ctx = []
        for w in context_words[-(self.order - 1):]:
            cid = self.word_id(w)
            if cid is not None and cid != self._unk_id:
                ctx.append(cid)
        return self.score_word_ids(tuple(ctx), wid)

    # -- enumeration (tries, unlike probing hashes, are walkable) ----------

    def to_ngram_lm(self) -> NgramLM:
        """Enumerate every n-gram back into an NgramLM (requires the vocab
        strings section). Probing binaries cannot do this — their stored
        keys are hashes; this is what lets trie .klm files feed the
        device-resident beam LM (decode/device_lm.pack_device_lm)."""
        if not self.words:
            raise ValueError(
                "trie binary has no vocab strings section; cannot rebuild "
                "word tuples"
            )
        lm = NgramLM(self.order)
        for w in self.words:
            lm.add_word(w)

        def emit(order_n, path_ids, prob10, backoff10):
            # path is (w, c_{n-1}, ..., c1); the n-gram is reversed(path)
            ngram = tuple(self.words[i] for i in reversed(path_ids))
            lm.add_ngram(ngram, prob10, backoff10)

        n_vocab = self.counts[0]
        for w in range(n_vocab):
            p, b = self._unigram[w]
            if w == 0 and p <= -99 * LOG10 and b == 0.0:
                pass  # synthesized <unk>; keep it anyway for parity
            emit(1, (w,), p / LOG10, b / LOG10)
            self._walk(2, (w,), int(self._uni_next[w]), int(self._uni_next[w + 1]), emit)
        return lm

    def _walk(self, order_n, path, begin, end, emit):
        level = self._level(order_n)
        for i in range(begin, end):
            if order_n < self.order:
                word, p, b, nb, ne = level.read(i)
                emit(order_n, path + (word,), p, b)
                self._walk(order_n + 1, path + (word,), nb, ne, emit)
            else:
                word, p = level.read(i)
                emit(order_n, path + (word,), p, 0.0)


def parse_kenlm_trie(data: bytes) -> KenLMTrieModel:
    if not data.startswith(MAGIC_PREFIX):
        raise ValueError("Not a KenLM binary (bad magic)")
    if not data.startswith(MAGIC):
        raise ValueError("Unsupported KenLM binary format version")
    order = data[_SANITY_SIZE]
    model_type = int(np.frombuffer(data, np.int32, 1, _SANITY_SIZE + 8)[0])
    has_vocab = data[_SANITY_SIZE + 12] != 0
    if model_type not in (
        MODEL_TRIE, MODEL_QUANT_TRIE, MODEL_ARRAY_TRIE, MODEL_QUANT_ARRAY_TRIE
    ):
        raise ValueError(f"not a trie binary (model type {model_type})")
    quantized = model_type in (MODEL_QUANT_TRIE, MODEL_QUANT_ARRAY_TRIE)
    bhiksha = model_type in (MODEL_ARRAY_TRIE, MODEL_QUANT_ARRAY_TRIE)
    counts = [
        int(c) for c in np.frombuffer(data, np.uint64, order, _SANITY_SIZE + 20)
    ]
    off = _align8(_SANITY_SIZE + 20 + 8 * order)

    # SortedVocabulary: entry count + sorted hashes (<unk> excluded)
    n_hashes = int(np.frombuffer(data, np.uint64, 1, off)[0])
    off += 8
    hashes = np.frombuffer(data, np.uint64, n_hashes, off).copy()
    off += 8 * counts[0]  # allocation is counts[0] slots (lm/vocab.cc Size)

    # Quantizer tables (lm/quantize.cc SeparatelyQuantize::SetupMemory)
    mid_prob_bins: list[_Bins | None] = [None] * max(order - 2, 0)
    mid_backoff_bins: list[_Bins | None] = [None] * max(order - 2, 0)
    longest_prob_bins: _Bins | None = None
    if quantized:
        prob_bits = data[off]
        backoff_bits = data[off + 1]
        if not (1 <= prob_bits <= 25 and 1 <= backoff_bits <= 25):
            raise ValueError(
                f"implausible quant bits ({prob_bits}, {backoff_bits})"
            )
        off += 8
        for n in range(2, order):
            pc = np.frombuffer(data, np.float32, 1 << prob_bits, off)
            off += 4 * (1 << prob_bits)
            bc = np.frombuffer(data, np.float32, 1 << backoff_bits, off)
            off += 4 * (1 << backoff_bits)
            mid_prob_bins[n - 2] = _Bins(pc)
            mid_backoff_bins[n - 2] = _Bins(bc)
        lc = np.frombuffer(data, np.float32, 1 << prob_bits, off)
        off += 4 * (1 << prob_bits)
        longest_prob_bins = _Bins(lc)

    # Unigram: (counts[0] + 2) x 16B
    n_uni = counts[0] + 2
    raw = np.frombuffer(data, np.uint8, n_uni * 16, off).reshape(n_uni, 16)
    uni_pb = raw[:, :8].copy().view(np.float32).reshape(n_uni, 2).astype(np.float64) * LOG10
    uni_next = raw[:, 8:].copy().view(np.uint64).ravel()
    off += n_uni * 16

    word_bits = required_bits(counts[0])
    middles = []
    for n in range(2, order):
        entries = counts[n - 1]
        max_next = counts[n] if n + 1 <= order else 0
        offsets = None
        if bhiksha:
            version = data[off]
            if version != _BHIKSHA_VERSION:
                raise ValueError(f"unknown Bhiksha array version {version}")
            pointer_bits = data[off + 1]
            off += 8
            next_bits = _bhiksha_inline_bits(entries + 1, max_next, pointer_bits)
            n_offsets = (max_next >> next_bits) + 1
            offsets = np.frombuffer(data, np.uint64, n_offsets, off).copy()
            off += 8 * n_offsets
        else:
            next_bits = required_bits(max_next)
        if quantized:
            total_bits = (
                word_bits
                + len(mid_prob_bins[n - 2].centers).bit_length() - 1
                + len(mid_backoff_bins[n - 2].centers).bit_length() - 1
                + next_bits
            )
        else:
            total_bits = word_bits + 63 + next_bits
        nbytes = ((1 + entries) * total_bits + 7) // 8 + 8
        middles.append(
            _Middle(
                data[off : off + nbytes], entries, word_bits, next_bits,
                prob_bins=mid_prob_bins[n - 2],
                backoff_bins=mid_backoff_bins[n - 2],
                bhiksha_offsets=offsets,
            )
        )
        off += nbytes
    if order > 1:
        entries = counts[order - 1]
        prob_width = (
            31 if longest_prob_bins is None
            else len(longest_prob_bins.centers).bit_length() - 1
        )
        total_bits = word_bits + prob_width
        nbytes = ((1 + entries) * total_bits + 7) // 8 + 8
        longest = _Longest(
            data[off : off + nbytes], entries, word_bits,
            prob_bins=longest_prob_bins,
        )
        off += nbytes
    else:
        longest = None

    words, vocab = [], {}
    if has_vocab and off < len(data):
        raw_words = data[off:].split(b"\0")
        words = [w.decode("utf-8", errors="replace") for w in raw_words if w]
        words = words[: counts[0]]
        vocab = {w: i for i, w in enumerate(words)}

    model = KenLMTrieModel(
        order, counts, vocab, words, hashes, uni_pb, middles, longest
    )
    model._uni_next = uni_next
    return model


def load_kenlm_trie(path: str) -> KenLMTrieModel:
    with open(path, "rb") as f:
        return parse_kenlm_trie(f.read())


# ---------------------------------------------------------------------------
# Writer — NgramLM -> trie binary (the round-trip oracle; kenlm's own
# tools are not a dependency, so the tests make their fixtures with it)
# ---------------------------------------------------------------------------


def write_kenlm_trie(
    lm: NgramLM,
    out_path: str,
    quantized: bool = False,
    bhiksha: bool = False,
    prob_bits: int = 8,
    backoff_bits: int = 8,
    pointer_bhiksha_bits: int = 64,
) -> None:
    """Serialize an NgramLM to the trie layout above, optionally with
    quantization (``build_binary -q/-b``) and/or Bhiksha next-pointer
    compression (``-a``).

    Like kenlm's builder, lower-order entries that exist only as suffixes
    of longer n-grams (structural "holes") are materialized with their
    backed-off probability and zero backoff — scoring through them is then
    exact (lm/search_trie.cc does the same).
    """
    order = lm.order

    # --- sorted-vocab binary ids: <unk>=0, others by murmur hash rank ----
    plain_words = [w for w in lm.words if w != _UNK]
    hashed = sorted(
        (murmur_hash64a(w.encode("utf-8")), w) for w in plain_words
    )
    sorted_hashes = np.array([h for h, _ in hashed], np.uint64)
    bin_words = [_UNK] + [w for _, w in hashed]
    bin_id = {w: i for i, w in enumerate(bin_words)}
    remap = {lm.vocab[w]: bin_id[w] for w in lm.words}
    n_vocab = len(bin_words)

    # --- collect reversed-path entries per level, with hole filling ------
    # level n dict: path (w, c_{n-1}, .., c1) -> [prob10, backoff10]
    levels: list[dict] = [dict() for _ in range(order + 1)]  # 1-indexed
    for n in range(1, order + 1):
        for ids, (p, b) in lm.tables[n - 1].items():
            path = tuple(remap[i] for i in reversed(ids))
            levels[n][path] = [p / LOG10, b / LOG10]
    # structural holes: every path prefix must exist
    inv = {v: k2 for k2, v in remap.items()}  # invariant — hoisted out of
    # the per-hole loop (was an O(vocab) dict build per hole)
    for n in range(order, 1, -1):
        for path in list(levels[n]):
            for k in range(n - 1, 0, -1):
                prefix = path[:k]
                if prefix not in levels[k]:
                    # backed-off probability of the suffix n-gram
                    # prefix == (w, c_{k-1}..c1) -> ngram (c1..c_{k-1}, w)
                    rev = tuple(reversed(prefix))
                    ctx, w = rev[:-1], rev[-1]
                    p_nat = lm.score_word_ids(
                        tuple(inv[c] for c in ctx), inv[w]
                    )
                    levels[k][prefix] = [p_nat / LOG10, 0.0]
    if not levels[1].get((0,)):
        levels[1][(0,)] = [-100.0, 0.0]  # synthesized <unk>
    for w in range(n_vocab):
        levels[1].setdefault((w,), [-100.0, 0.0])

    counts = [len(levels[n]) for n in range(1, order + 1)]
    counts[0] = n_vocab

    sorted_paths = [None] + [
        sorted(levels[n].keys()) for n in range(1, order + 1)
    ]

    # child ranges: level n+1 items grouped under their level-n prefix
    def child_ranges(n):
        """For each level-n path (sorted), the [begin, end) range into the
        sorted level-(n+1) array."""
        parents = sorted_paths[n]
        children = sorted_paths[n + 1] if n + 1 <= order else []
        ranges = []
        ci = 0
        for p in parents:
            while ci < len(children) and children[ci][: n] < p:
                ci += 1
            begin = ci
            while ci < len(children) and children[ci][: n] == p:
                ci += 1
            ranges.append((begin, ci))
        return ranges

    if quantized:
        model_type = MODEL_QUANT_ARRAY_TRIE if bhiksha else MODEL_QUANT_TRIE
    else:
        model_type = MODEL_ARRAY_TRIE if bhiksha else MODEL_TRIE

    buf = bytearray()
    sanity = bytearray(_SANITY_SIZE)
    sanity[: len(MAGIC)] = MAGIC
    sanity[_MAGIC_FIELD : _MAGIC_FIELD + 12] = np.array(
        [0.0, 1.0, -0.5], np.float32
    ).tobytes()
    sanity[68:76] = np.array([1, 0xFFFFFFFF], np.uint32).tobytes()
    sanity[80:88] = np.array([1], np.uint64).tobytes()
    buf += sanity
    params = bytearray(20)
    params[0] = order
    params[4:8] = np.float32(1.5).tobytes()
    params[8:12] = np.int32(model_type).tobytes()
    params[12] = 1  # has_vocabulary
    params[16:20] = np.uint32(1).tobytes()  # search version (kSearchVersion)
    buf += params
    buf += np.array(counts, np.uint64).tobytes()
    buf += b"\0" * (_align8(len(buf)) - len(buf))

    # SortedVocabulary: count + hashes, padded to counts[0] u64 slots
    buf += np.uint64(len(sorted_hashes)).tobytes()
    buf += sorted_hashes.tobytes()
    buf += b"\0" * 8 * (counts[0] - len(sorted_hashes))

    # quantizer training + tables (SeparatelyQuantize)
    mid_prob_bins: list[_Bins | None] = [None] * max(order - 2, 0)
    mid_backoff_bins: list[_Bins | None] = [None] * max(order - 2, 0)
    longest_prob_bins: _Bins | None = None
    all_ranges = {n: child_ranges(n) for n in range(1, order)}
    if quantized:
        head = bytearray(8)
        head[0] = prob_bits
        head[1] = backoff_bits
        buf += head
        for n in range(2, order):
            probs = [levels[n][p][0] for p in sorted_paths[n]]
            backoffs = [
                levels[n][p][1] for p in sorted_paths[n]
                if levels[n][p][1] != 0.0
            ]
            pc = _make_bins(probs, 1 << prob_bits)
            bc = np.zeros(1 << backoff_bits, np.float32)
            bc[0] = 0.0
            bc[1] = -0.0
            bc[2:] = _make_bins(backoffs, (1 << backoff_bits) - 2)
            mid_prob_bins[n - 2] = _Bins(pc)
            mid_backoff_bins[n - 2] = _Bins(bc)
            buf += pc.tobytes() + bc.tobytes()
        lp = _make_bins(
            [levels[order][p][0] for p in sorted_paths[order]], 1 << prob_bits
        )
        longest_prob_bins = _Bins(lp)
        buf += lp.tobytes()

    # Unigram array
    uni = np.zeros((counts[0] + 2, 4), np.float32)  # prob, backoff, next lo/hi
    uni_next = np.zeros(counts[0] + 2, np.uint64)
    ranges1 = all_ranges[1] if order > 1 else [(0, 0)] * counts[0]
    for i, path in enumerate(sorted_paths[1]):
        w = path[0]
        p, b = levels[1][path]
        uni[w, 0], uni[w, 1] = p, b
        uni_next[w] = ranges1[i][0]
    # tail entries carry the end pointer
    end1 = counts[1] if order > 1 else 0
    uni_next[counts[0]] = end1
    uni_next[counts[0] + 1] = end1
    raw = np.zeros((counts[0] + 2, 16), np.uint8)
    raw[:, :8] = uni[:, :2].copy().view(np.uint8).reshape(-1, 8)
    raw[:, 8:] = uni_next.view(np.uint8).reshape(-1, 8)
    buf += raw.tobytes()

    word_bits = required_bits(counts[0])

    # middle levels
    for n in range(2, order):
        entries = counts[n - 1]
        max_next = counts[n]
        ranges = all_ranges[n]
        # next values per record (ranges begins) + the extra end record
        next_values = [r[0] for r in ranges] + [max_next]
        if bhiksha:
            next_bits = _bhiksha_inline_bits(
                entries + 1, max_next, pointer_bhiksha_bits
            )
            head = bytearray(8)
            head[0] = _BHIKSHA_VERSION
            head[1] = pointer_bhiksha_bits
            buf += head
            # offset array: offsets[h] = first record index with
            # next >> inline >= h (lm/bhiksha.hh WriteNext)
            offsets = np.zeros((max_next >> next_bits) + 1, np.uint64)
            w_to = 1
            for i, v in enumerate(next_values):
                encode = v >> next_bits
                while w_to <= encode:
                    offsets[w_to] = i
                    w_to += 1
            while w_to < len(offsets):
                offsets[w_to] = len(next_values)
                w_to += 1
            buf += offsets.tobytes()
        else:
            next_bits = required_bits(max_next)
        if quantized:
            pw, bw = prob_bits, backoff_bits
        else:
            pw, bw = 31, 32
        total_bits = word_bits + pw + bw + next_bits
        wtr = _BitWriter((1 + entries) * total_bits)
        next_mask = (1 << next_bits) - 1
        for i, path in enumerate(sorted_paths[n]):
            p, b = levels[n][path]
            off = i * total_bits
            wtr.write(off, word_bits, path[-1])
            if quantized:
                wtr.write(off + word_bits, pw, mid_prob_bins[n - 2].encode_prob(p))
                wtr.write(
                    off + word_bits + pw, bw,
                    mid_backoff_bins[n - 2].encode_backoff(
                        b, has_extension=ranges[i][0] < ranges[i][1]
                    ),
                )
            else:
                wtr.write(off + word_bits, 31, _float_to_31(p))
                wtr.write(off + word_bits + 31, 32, _float_to_32(b))
            wtr.write(
                off + word_bits + pw + bw, next_bits, ranges[i][0] & next_mask
            )
        # final end pointer in the extra record's next field
        wtr.write(
            entries * total_bits + word_bits + pw + bw,
            next_bits,
            max_next & next_mask,
        )
        buf += bytes(wtr.buf)

    # longest level
    if order > 1:
        entries = counts[order - 1]
        pw = prob_bits if quantized else 31
        total_bits = word_bits + pw
        wtr = _BitWriter((1 + entries) * total_bits)
        for i, path in enumerate(sorted_paths[order]):
            p, _ = levels[order][path]
            off = i * total_bits
            wtr.write(off, word_bits, path[-1])
            if quantized:
                wtr.write(off + word_bits, pw, longest_prob_bins.encode_prob(p))
            else:
                wtr.write(off + word_bits, 31, _float_to_31(p))
        buf += bytes(wtr.buf)

    # vocab strings in binary-id order
    for w in bin_words:
        buf += w.encode("utf-8") + b"\0"

    with open(out_path, "wb") as f:
        f.write(bytes(buf))
