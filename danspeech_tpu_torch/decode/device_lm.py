"""Device-resident n-gram LM scoring for the on-device beam search.

The port of ``danspeech_tpu.decode.device_lm``. The n-gram tables live on
the engine's device (CUDA unless the caller asks for the CPU) and words are
scored inside the beam search's frame step with plain torch ops:

- :func:`pack_device_lm` flattens an :class:`~.lm.NgramLM` into a
  bucketized two-choice hash table (keys are a pair of independent 32-bit
  multiplicative fingerprints over word ids) plus a vocabulary table that
  maps a rolling hash of a word's *label characters* to its word id. The
  host builder is a copy of the JAX package's, so the tables are equal
  word for word;
- :func:`boundary_scores` computes alpha * ln p(word | context) + beta for
  each beam's just-completed word with the standard backoff recursion,
  vectorized over (batch, beam) by gathers of whole buckets;
- :func:`init_lm_state` / :func:`reconstruct_lm_state` thread the per-beam
  LM state (last order-1 word ids, rolling current-word hash) through the
  beam search: the state of a merged candidate is recomputed from its
  (parent, emitted char) pointer.

32-bit hash arithmetic: torch has no wrapping ``uint32`` arithmetic, so
every hash is carried in ``int64`` in [0, 2**32) and every multiply-add is
reduced mod 2**32 (:func:`_mul32` splits the constant so that no ``int64``
product overflows). The tables are ``int64`` too, each 32-bit word
zero-extended: the lane selection takes a max over the matched lanes'
value words, which an ``int32`` table would lose for every negative
log-probability (its bits are negative as ``int32``). A value word becomes
a float32 through its low 32 bits.

Scoring semantics match the host scorers (decode/lm.py NgramLM /
native/ctcbeam): natural-log probabilities, OOV words at -1000, OOV
context words dropped from the context window at scoring time (they still
occupy a slot of the last order-1 words), empty words (double space)
score 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

OOV_SCORE = -1000.0

_M32 = 0xFFFFFFFF
_B31 = 1 << 31
# word-character rolling hash (current partial word)
_WM1 = 0x01000193  # FNV-ish odd multipliers
_WM2 = 0x61C88647
# n-gram word-id chain
_NM1 = 0x9E3779B1
_NM2 = 0x85EBCA77
_NG_SEED1 = 0x811C9DC5
_NG_SEED2 = 0xC2B2AE35
# bucket-index mixes (one per hash choice)
_SLOT_MIX = 0x7FEB352D
_SLOT_MIX2 = 0x846CA68B


def _h_word(char_ids) -> tuple[int, int]:
    """Host-side rolling hash of a word's label-character ids."""
    h1 = h2 = 0
    for c in char_ids:
        h1 = (h1 * _WM1 + c + 1) & _M32
        h2 = (h2 * _WM2 + c + 1) & _M32
    return h1, h2


def _h_ngram(word_ids) -> tuple[int, int]:
    """Host-side fingerprint chain over word ids (oldest first)."""
    h1, h2 = _NG_SEED1, _NG_SEED2
    for w in word_ids:
        h1 = (h1 * _NM1 + w + 1) & _M32
        h2 = (h2 * _NM2 + w + 1) & _M32
    if h1 == 0 and h2 == 0:  # keep (0,0) free as the empty-slot sentinel
        h1 = h2 = 1
    return h1, h2


def _buckets2(h1: int, h2: int, n_buckets: int) -> tuple[int, int]:
    """Host-side candidate bucket pair of a key (two-choice hashing)."""
    b1 = ((h1 ^ ((h2 * _SLOT_MIX) & _M32)) & _M32) % n_buckets
    b2 = ((h2 ^ ((h1 * _SLOT_MIX2) & _M32)) & _M32) % n_buckets
    return b1, b2


class _BucketTableBuilder:
    """Two-choice bucketized hash table: each key may live in either of
    two candidate buckets of ``max_probe`` entry lanes (greedy less-full
    placement — the classic power-of-two-choices load balance), and every
    lane packs (k1, k2, v0, v1) into four consecutive 32-bit words. The
    device lookup gathers exactly TWO (max_probe, 4)-word bucket rows per
    query — independent of table size — and matches across the
    2 x max_probe lanes. Grows the bucket count and rehashes in the (rare,
    load-bounded) case both candidate buckets overflow.

    The JAX package's builder, with the placement decisions taken on
    Python lists and a set of keys instead of numpy slices (the same
    decisions, so the same table, in a fraction of the time), and the
    lanes written in one numpy assignment at the end."""

    def __init__(self, n_entries: int, n_values: int, max_probe: int,
                 load: float):
        if n_values > 2:
            raise ValueError("bucket slots pack at most 2 values")
        self.max_probe = max_probe
        self.n_values = n_values
        # load = slot headroom (1.0 = exactly as many lanes as entries)
        self.n_buckets = max(2, int(n_entries * load / max_probe) + 1)

    def insert_all(self, entries):
        """entries: list of (h1, h2, value-tuple of raw uint32 words).
        Retries with more buckets until nothing overflows."""
        while True:
            slots = self._place(entries)
            if slots is not None:
                break
            self.n_buckets = int(self.n_buckets * 1.5) + 1
        # (nb, P, 4) u32: [k1, k2, value0, value1] (values pre-bitcast)
        self.table = np.zeros((self.n_buckets, self.max_probe, 4), np.uint32)
        if entries:
            words = np.zeros((len(entries), 4), np.uint32)
            words[:, 0] = [e[0] for e in entries]
            words[:, 1] = [e[1] for e in entries]
            for i in range(self.n_values):
                words[:, 2 + i] = [e[2][i] for e in entries]
            slots = np.asarray(slots)
            self.table[slots[:, 0], slots[:, 1]] = words

    def _place(self, entries):
        """The (bucket, lane) of every entry, in order: each goes to the
        less full of its two candidate buckets (the first on a tie); None
        when one finds both full."""
        fill = [0] * self.n_buckets
        keys = set()
        slots = []
        cap = self.max_probe
        for h1, h2, _ in entries:
            if (h1, h2) in keys:
                raise ValueError("duplicate key in device LM table")
            keys.add((h1, h2))
            b1, b2 = _buckets2(h1, h2, self.n_buckets)
            b = b2 if fill[b2] < fill[b1] else b1
            if fill[b] >= cap:
                return None
            slots.append((b, fill[b]))
            fill[b] += 1
        return slots


class DeviceLM:
    """N-gram LM packed as tensors on one device.

    ng_table — (NB, P, 4) int64 buckets: [k1, k2, ln-prob bits, ln-backoff
    bits] per entry lane, each a zero-extended 32-bit word (the bits of a
    float32);
    voc_table — (VB, P, 4) int64 buckets: [k1, k2, word id, 0].
    """

    def __init__(self, order, max_probe, ng_table, voc_table):
        self.order = int(order)
        self.max_probe = int(max_probe)
        self.ng_table = ng_table
        self.voc_table = voc_table

    @property
    def device(self) -> torch.device:
        return self.ng_table.device

    def to(self, device=None) -> "DeviceLM":
        """This LM on ``device`` (``None`` means CUDA): itself when the
        tables are there already, else a copy."""
        dev = resolve_device(device)
        here = self.device
        if here.type == dev.type and dev.index in (None, here.index):
            return self
        return DeviceLM(self.order, self.max_probe, self.ng_table.to(dev),
                        self.voc_table.to(dev))

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.ng_table, self.voc_table))


def pack_device_lm(lm, labels: str, max_probe: int = 4,
                   load: float = 1.6, device=None) -> DeviceLM:
    """Pack an NgramLM (decode/lm.py) into a :class:`DeviceLM` on
    ``device`` (``None`` means CUDA).

    ``labels`` is the acoustic label string: the vocabulary table is keyed
    by each word's label-character ids (the only spelling the beam search
    can produce), so LM words containing characters outside ``labels`` are
    unreachable and skipped.
    """
    dev = resolve_device(device)
    char_index = {ch: i for i, ch in enumerate(labels)}

    voc_entries = []
    seen = {}
    for wid, word in enumerate(lm.words):
        try:
            ids = [char_index[ch] for ch in word]
        except KeyError:
            continue
        if not ids:
            continue
        key = _h_word(ids)
        if key == (0, 0):  # would alias the empty-slot sentinel
            raise ValueError(f"word hash hit the empty sentinel: {word!r}")
        if key in seen:  # 64-bit-equivalent hash collision: effectively
            raise ValueError(  # impossible at zoo-vocabulary sizes
                f"vocab hash collision: {word!r} vs {lm.words[seen[key]]!r}"
            )
        seen[key] = wid
        voc_entries.append((key[0], key[1], (np.uint32(wid),)))

    ng_entries = []
    for table in lm.tables:
        for ids, (prob, backoff) in table.items():
            h1, h2 = _h_ngram(ids)
            ng_entries.append((
                h1, h2,
                (np.float32(prob).view(np.uint32),
                 np.float32(backoff).view(np.uint32)),
            ))

    vt = _BucketTableBuilder(len(voc_entries), 1, max_probe, load)
    vt.insert_all(voc_entries)
    nt = _BucketTableBuilder(len(ng_entries), 2, max_probe, load)
    nt.insert_all(ng_entries)

    def upload(table):
        return torch.from_numpy(table.astype(np.int64)).to(dev)

    return DeviceLM(
        order=lm.order,
        max_probe=max_probe,
        ng_table=upload(nt.table),
        voc_table=upload(vt.table),
    )


# ---------------------------------------------------------------------------
# 32-bit hash arithmetic on int64 tensors
# ---------------------------------------------------------------------------


def _mul32(a, m: int):
    """(a * m) mod 2**32 for ``a`` in [0, 2**32) (an int64 tensor or an int)
    and a 32-bit constant ``m``, without an int64 product above 2**63: a
    constant of 2**31 or more is split as (m - 2**31) + 2**31, and
    a * 2**31 mod 2**32 is the low bit of ``a`` shifted up."""
    if m < _B31:
        return (a * m) & _M32
    return (((a * (m - _B31)) & _M32) + ((a & 1) << 31)) & _M32


def _mul_add32(a, m: int, c):
    """(a * m + c) mod 2**32, ``c`` in [0, 2**32]."""
    return (_mul32(a, m) + c) & _M32


def _bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """The float32 whose bits are the low 32 bits of ``bits`` (int64 in
    [0, 2**32))."""
    signed = torch.where(bits >= _B31, bits - (1 << 32), bits)
    return signed.to(torch.int32).view(torch.float32)


# ---------------------------------------------------------------------------
# Device-side probes
# ---------------------------------------------------------------------------


def _probe(table, q1, q2):
    """Vectorized two-choice bucket probe against a packed (NB, P, 4)
    table. Returns (found, vals) with vals (..., 2) the raw value words
    (zero where not found); q1/q2 are int64 hashes of any (matching)
    shape. TWO gathered bucket rows per query."""
    nb = table.shape[0]
    b1 = (q1 ^ _mul32(q2, _SLOT_MIX)) % nb
    b2 = (q2 ^ _mul32(q1, _SLOT_MIX2)) % nb
    rows = torch.cat([table[b1], table[b2]], dim=-2)  # (..., 2P, 4)
    match = (rows[..., 0] == q1[..., None]) & (rows[..., 1] == q2[..., None])
    found = match.any(dim=-1)
    # at most one DISTINCT lane matches (when b1 == b2 the same lane shows
    # up twice); the words are non-negative, so the max over the lanes
    # picks the value either way, zeros elsewhere
    vals = torch.where(match[..., None], rows[..., 2:4], 0).amax(dim=-2)
    return found, vals


def lookup_word_ids(lm: DeviceLM, wh1, wh2):
    """Map rolling word hashes to word ids; -1 where the word is OOV."""
    found, vals = _probe(lm.voc_table, wh1, wh2)
    return torch.where(found, vals[..., 0], -1)


def _ngram_probe_stacked(lm: DeviceLM, q1, q2):
    """Probe a stack of n-gram queries (..., Q) in one two-row bucket
    gather. Returns (found, prob, backoff), each (..., Q)."""
    # the (0,0) -> (1,1) sentinel remap of the host packer
    sent = (q1 == 0) & (q2 == 0)
    q1 = torch.where(sent, 1, q1)
    q2 = torch.where(sent, 1, q2)
    found, vals = _probe(lm.ng_table, q1, q2)
    fv = _bits_to_f32(vals)  # (..., Q, 2)
    prob = torch.where(found, fv[..., 0], 0.0)
    backoff = torch.where(found, fv[..., 1], 0.0)
    return found, prob, backoff


def _compact_context(ctx):
    """Right-align the valid (>= 0) entries of the last-axis context
    buffer, preserving order; invalid slots become -1 on the left.

    Mirrors the host scorers: OOV words occupy a slot of the last order-1
    words but are dropped from the scoring context (lm.py score_word).
    Returns (compacted (..., K) int64, m (...,) int64 valid count).
    """
    k = ctx.shape[-1]
    valid = ctx >= 0
    # count of valid entries at or after each position
    cnt_ge = valid.flip(-1).long().cumsum(-1).flip(-1)
    tgt = k - cnt_ge  # output slot for each valid entry
    slots = torch.arange(k, device=ctx.device)
    onehot = (tgt[..., :, None] == slots) & valid[..., :, None]
    compacted = torch.where(
        onehot.any(dim=-2),
        torch.where(onehot, ctx[..., :, None], 0).sum(dim=-2),
        -1,
    )
    return compacted, valid.sum(dim=-1)


def _chain(h1, h2, wid):
    """Extend an n-gram fingerprint chain by one word id (32-bit math)."""
    w = wid + 1
    return _mul_add32(h1, _NM1, w), _mul_add32(h2, _NM2, w)


def score_word_ids(lm: DeviceLM, ctx, wid):
    """ln p(wid | ctx) with backoff, vectorized over leading dims.

    ctx: (..., order-1) int64 word ids oldest-first, -1 = absent/OOV slot;
    wid: (...,) int64, -1 = OOV (scores OOV_SCORE). Matches
    NgramLM.score_word_ids / the native C++ scorer semantics. All
    2*(order-1)+1 backoff-recursion lookups go out as ONE stacked probe.
    """
    kmax = lm.order - 1
    wid_safe = wid.clamp_min(0)
    seed1 = torch.full_like(wid, _NG_SEED1)
    seed2 = torch.full_like(wid, _NG_SEED2)

    if kmax == 0:
        h1, h2 = _chain(seed1, seed2, wid_safe)
        found, prob, _ = _ngram_probe_stacked(lm, h1[..., None], h2[..., None])
        score = torch.where(found[..., 0], prob[..., 0], OOV_SCORE)
        return torch.where(wid < 0, OOV_SCORE, score)

    cmp_ctx, m = _compact_context(ctx)
    ctx_safe = cmp_ctx.clamp_min(0)

    # fingerprint chains of every context suffix: suffix of length k spans
    # positions [kmax-k, kmax). K <= 4, so the O(K^2) unroll is tiny.
    suf1 = [seed1] + [None] * kmax  # suffix length -> (h1, h2)
    suf2 = [seed2] + [None] * kmax
    for klen in range(1, kmax + 1):
        h1, h2 = _NG_SEED1, _NG_SEED2
        for p in range(kmax - klen, kmax):
            h1, h2 = _chain(h1, h2, ctx_safe[..., p])
        suf1[klen], suf2[klen] = h1, h2

    # stack ALL lookups into one probe: prob queries (suffix + word) for
    # klen = kmax..0 at positions [0, kmax], then backoff queries (suffix
    # alone) for klen = kmax..1 at positions [kmax+1, 2*kmax]
    pq = [_chain(suf1[klen], suf2[klen], wid_safe) for klen in range(kmax, -1, -1)]
    bq = [(suf1[klen], suf2[klen]) for klen in range(kmax, 0, -1)]
    q1 = torch.stack([q[0] for q in pq + bq], dim=-1)  # (..., 2*kmax+1)
    q2 = torch.stack([q[1] for q in pq + bq], dim=-1)
    found, prob, backoff = _ngram_probe_stacked(lm, q1, q2)

    result = torch.full(wid.shape, OOV_SCORE, dtype=torch.float32,
                        device=wid.device)
    done = torch.zeros(wid.shape, dtype=torch.bool, device=wid.device)
    backoff_acc = torch.zeros(wid.shape, dtype=torch.float32, device=wid.device)
    for klen in range(kmax, -1, -1):
        pi = kmax - klen  # position of this level's prob query
        applicable = klen <= m
        hit = applicable & ~done & found[..., pi]
        result = torch.where(hit, backoff_acc + prob[..., pi], result)
        done = done | hit
        if klen > 0:
            bi = kmax + 1 + (kmax - klen)  # this level's backoff query
            backoff_acc = backoff_acc + torch.where(
                applicable & ~done & found[..., bi], backoff[..., bi], 0.0
            )
    return torch.where(wid < 0, OOV_SCORE, result)


# ---------------------------------------------------------------------------
# Beam-search integration
# ---------------------------------------------------------------------------


def init_lm_state(batch: int, w: int, order: int, device=None):
    """Per-beam LM state: (ctx, cw_h1, cw_h2, cw_len), on ``device``
    (``None`` means CUDA).

    ctx — (B, W, order-1) int64 last completed word ids (-1 = absent/OOV);
    cw_* — rolling hash pair of the current partial word; cw_len — its
    character count (0 = at a word boundary).
    """
    dev = resolve_device(device)
    kmax = max(order - 1, 1)
    zeros = torch.zeros((batch, w), dtype=torch.int64, device=dev)
    return (
        torch.full((batch, w, kmax), -1, dtype=torch.int64, device=dev),
        zeros, zeros.clone(), zeros.clone(),
    )


def boundary_scores(lm: DeviceLM, lm_state, alpha: float, beta: float):
    """(bscore, wid) per beam: the LM bonus the beam earns if the next
    emitted char completes its current word (i.e. is a space), and the
    current word's vocab id (-1 = OOV) for the context push.

    bscore = alpha * ln p(word | ctx) + beta; 0 for an empty word (double
    space), reproducing the host _LMScorer.score_boundary (decode/beam.py).
    """
    ctx, cw_h1, cw_h2, cw_len = lm_state
    wid = lookup_word_ids(lm, cw_h1, cw_h2)
    s = score_word_ids(lm, ctx, wid)
    has_word = cw_len > 0
    wid = torch.where(has_word, wid, -1)
    return torch.where(has_word, alpha * s + beta, 0.0), wid


def reconstruct_lm_state(lm_state, parent, char, wid, space: int):
    """LM state of each merged candidate from its (parent, emitted char).

    The LM state is a pure function of the prefix, and a merged candidate's
    prefix is parent-prefix + char — so instead of carrying the LM state
    through the merge, gather the parent's state and apply one char
    update. ``parent``/``char`` are the (B, W) backtrack pointers the merge
    emits (char -1 = no emission), ``wid`` the per-parent current-word ids
    from :func:`boundary_scores`.
    """
    ctx, cw_h1, cw_h2, cw_len = lm_state
    g2 = lambda a: torch.gather(a, 1, parent)  # noqa: E731
    p_ctx = torch.gather(ctx, 1, parent[..., None].expand(-1, -1, ctx.shape[-1]))
    p_h1, p_h2, p_len = g2(cw_h1), g2(cw_h2), g2(cw_len)
    p_wid = g2(wid)

    is_space = char == space
    is_char = (char >= 0) & ~is_space

    pushed = torch.cat([p_ctx[..., 1:], p_wid[..., None]], dim=-1)
    new_ctx = torch.where((is_space & (p_len > 0))[..., None], pushed, p_ctx)

    c = torch.where(is_char, char, 0) + 1
    up_h1 = _mul_add32(p_h1, _WM1, c)
    up_h2 = _mul_add32(p_h2, _WM2, c)
    new_h1 = torch.where(is_space, 0, torch.where(is_char, up_h1, p_h1))
    new_h2 = torch.where(is_space, 0, torch.where(is_char, up_h2, p_h2))
    new_len = torch.where(is_space, 0, p_len + is_char.long())
    return new_ctx, new_h1, new_h2, new_len


def final_scores(lm: DeviceLM, lm_state, last, alpha: float, beta: float,
                 space: int):
    """End-of-utterance LM bonus: prefixes not ending in space score their
    trailing partial word (host oracle decode/beam.py prefix_beam_search
    final loop; ctcdecode semantics)."""
    bscore, _ = boundary_scores(lm, lm_state, alpha, beta)
    return torch.where((last >= 0) & (last != space), bscore, 0.0)
