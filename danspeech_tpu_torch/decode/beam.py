"""CTC prefix beam search with word-level n-gram LM fusion.

Replaces the reference's external C++ ``ctcdecode`` extension
(decoder.py:91-144; SURVEY §2.2 N2) with the same algorithm and scoring
semantics (Hannun-style prefix beam search; LM applied on word boundaries
as alpha * ln p(word | context) + beta, trailing partial word scored at the
end, OOV at -1000):

- this module: reference Python implementation (correctness oracle, used
  for tests and small inputs);
- native/ctcbeam: the C++ production implementation with the same scoring,
  threaded across utterances (selected automatically when built).

The acoustic input is a (B, T, C) tensor of *probabilities* (the model
applies softmax at inference, reference model.py:84-93).

A copy of ``danspeech_tpu.decode.beam``.
"""

from __future__ import annotations

import math
import warnings

import numpy as np

from .greedy import Decoder
from .lm import NgramLM, PackedNgramLM, load_lm

NEG_INF = -math.inf


def _logaddexp(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    if a < b:
        a, b = b, a
    return a + math.log1p(math.exp(b - a))


class _Beam:
    __slots__ = ("log_pb", "log_pnb")

    def __init__(self, log_pb=NEG_INF, log_pnb=NEG_INF):
        self.log_pb = log_pb
        self.log_pnb = log_pnb

    def total(self) -> float:
        return _logaddexp(self.log_pb, self.log_pnb)


def _words_of(prefix: tuple, space: int) -> tuple[list[tuple], tuple]:
    """Split a label prefix into (completed word tuples, trailing partial)."""
    words = []
    cur = []
    for c in prefix:
        if c == space:
            if cur:
                words.append(tuple(cur))
            cur = []
        else:
            cur.append(c)
    return words, tuple(cur)


class _LMScorer:
    """Word-boundary LM scoring with per-word-string caching."""

    def __init__(self, lm, labels: str, alpha: float, beta: float, space_index: int):
        self.lm = lm
        self.labels = labels
        self.alpha = alpha
        self.beta = beta
        self.space = space_index
        self._cache: dict[tuple, float] = {}

    def word_str(self, word: tuple) -> str:
        return "".join(self.labels[c] for c in word)

    def score_boundary(self, prefix: tuple) -> float:
        """alpha * ln p(last word | previous words) + beta for the word that
        ``prefix`` just completed (``prefix`` does not yet include the
        boundary space)."""
        key = prefix
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        words, partial = _words_of(prefix, self.space)
        # at a boundary the "partial" is the word being completed
        context = [self.word_str(w) for w in words[-(self.lm.order - 1) :]]
        word = self.word_str(partial)
        if not word:
            score = 0.0  # double space: no word to score
        else:
            score = self.alpha * self.lm.score_word(context, word) + self.beta
        self._cache[key] = score
        return score


def prefix_beam_search(
    probs: np.ndarray,
    beam_width: int = 64,
    blank: int = 0,
    cutoff_top_n: int = 40,
    cutoff_prob: float = 1.0,
    scorer: _LMScorer | None = None,
):
    """Beam search over one utterance's (T, C) probability matrix.

    Returns a list of (label_tuple, score, times_tuple) sorted best-first.
    Scores are ln-domain CTC path sums plus LM terms.
    """
    t_max, n_classes = probs.shape
    log_probs = np.log(np.clip(probs, 1e-30, None))

    beams: dict[tuple, _Beam] = {(): _Beam(log_pb=0.0, log_pnb=NEG_INF)}
    # char emission frame per prefix node: prefix -> (best_ext_score, t);
    # shared across beams like the native decoder's trie-node time
    node_time: dict[tuple, tuple] = {}

    def offer_node_time(prefix: tuple, score: float, t: int):
        cur = node_time.get(prefix)
        if cur is None or score > cur[0]:
            node_time[prefix] = (score, t)

    for t in range(t_max):
        lp = log_probs[t]
        # per-frame candidate pruning (cutoff_top_n / cutoff_prob)
        if cutoff_top_n < n_classes or cutoff_prob < 1.0:
            order = np.argsort(-probs[t])
            if cutoff_prob < 1.0:
                csum = np.cumsum(probs[t][order])
                n_keep = int(np.searchsorted(csum, cutoff_prob) + 1)
            else:
                n_keep = n_classes
            candidates = order[: min(cutoff_top_n, n_keep)]
        else:
            candidates = range(n_classes)

        next_beams: dict[tuple, _Beam] = {}

        def get(prefix):
            b = next_beams.get(prefix)
            if b is None:
                b = _Beam()
                next_beams[prefix] = b
            return b

        for prefix, beam in beams.items():
            total = beam.total()
            last = prefix[-1] if prefix else None
            for c in candidates:
                p = lp[c]
                if c == blank:
                    nb = get(prefix)
                    nb.log_pb = _logaddexp(nb.log_pb, total + p)
                elif c == last:
                    # repeat without blank: merges into the same prefix
                    nb = get(prefix)
                    nb.log_pnb = _logaddexp(nb.log_pnb, beam.log_pnb + p)
                    # repeat after blank: extends the prefix
                    ext = prefix + (c,)
                    ne = get(ext)
                    score = beam.log_pb + p
                    if scorer is not None and c == scorer.space:
                        score += scorer.score_boundary(prefix)
                    ne.log_pnb = _logaddexp(ne.log_pnb, score)
                    offer_node_time(ext, score, t)
                else:
                    ext = prefix + (c,)
                    ne = get(ext)
                    score = total + p
                    if scorer is not None and c == scorer.space:
                        score += scorer.score_boundary(prefix)
                    ne.log_pnb = _logaddexp(ne.log_pnb, score)
                    offer_node_time(ext, score, t)

        # prune to beam width by total path probability
        pruned = sorted(next_beams.items(), key=lambda kv: -kv[1].total())
        beams = dict(pruned[:beam_width])

    # final scoring: trailing partial word gets its LM term
    # (ctcdecode scores prefixes not ending in space at the end)
    results = []
    for prefix, beam in beams.items():
        score = beam.total()
        if scorer is not None and prefix and prefix[-1] != scorer.space:
            score += scorer.score_boundary(prefix)
        times = tuple(node_time[prefix[: k + 1]][1] for k in range(len(prefix)))
        results.append((prefix, score, times))
    results.sort(key=lambda r: -r[1])
    return results


class BeamCTCDecoder(Decoder):
    """ctcdecode-compatible decoder facade (reference decoder.py:91-144).

    Constructor signature mirrors the reference BeamCTCDecoder (cutoffs,
    alpha/beta, beam width, worker count). ``lm_path`` may be an .arpa(.gz)
    file, a KenLM probing .klm binary, or None for LM-free beam search.
    """

    def __init__(
        self,
        labels: str,
        lm_path=None,
        alpha: float = 0.0,
        beta: float = 0.0,
        cutoff_top_n: int = 40,
        cutoff_prob: float = 1.0,
        beam_width: int = 100,
        num_processes: int = 4,
        blank_index: int = 0,
    ):
        super().__init__(labels, blank_index)
        self.beam_width = beam_width
        self.cutoff_top_n = cutoff_top_n
        self.cutoff_prob = cutoff_prob
        self.num_processes = num_processes
        self.alpha = alpha
        self.beta = beta
        self._native = None

        if lm_path is not None:
            from .kenlm_reader import KenLMProbingModel

            if isinstance(lm_path, (NgramLM, PackedNgramLM, KenLMProbingModel)):
                lm = lm_path
            else:
                lm = load_lm(lm_path)
            self.scorer = _LMScorer(lm, labels, alpha, beta, self.space_index)
        else:
            self.scorer = None

        # trie .klm models are walkable — convert so the native packer
        # (which needs enumerable .tables) gets an NgramLM instead of
        # silently losing the C++ path to the AttributeError below
        native_lm = self.scorer.lm if self.scorer else None
        if native_lm is not None and hasattr(native_lm, "to_ngram_lm"):
            native_lm = native_lm.to_ngram_lm()
        try:
            from .native_beam import NativeBeamDecoder

            self._native = NativeBeamDecoder(
                labels=labels,
                lm=native_lm,
                alpha=alpha,
                beta=beta,
                cutoff_top_n=cutoff_top_n,
                cutoff_prob=cutoff_prob,
                beam_width=beam_width,
                num_threads=num_processes,
                blank_index=blank_index,
                space_index=self.space_index,
            )
        except Exception as e:
            # build toolchain missing / unpackable LM (e.g. probing-hash
            # vocab without enumerable tables): pure-Python oracle decode
            warnings.warn(
                f"native beam decoder unavailable ({type(e).__name__}: {e});"
                " falling back to the pure-Python beam search",
                stacklevel=2,
            )
            self._native = None

    def decode(self, probs, sizes=None):
        """Decode (B, T, C) probabilities -> (strings, offsets).

        strings[b] is the beam list (best first), offsets[b][k] the frame
        index of each emitted char — same nested layout the reference
        produces via convert_to_strings/convert_tensor (decoder.py:102-127).
        """
        probs = np.asarray(probs)
        batch = probs.shape[0]
        all_strings, all_offsets = [], []
        for b in range(batch):
            size = int(sizes[b]) if sizes is not None else probs.shape[1]
            if self._native is not None:
                results = self._native.decode(probs[b, :size])
            else:
                results = prefix_beam_search(
                    probs[b, :size],
                    beam_width=self.beam_width,
                    blank=self.blank_index,
                    cutoff_top_n=self.cutoff_top_n,
                    cutoff_prob=self.cutoff_prob,
                    scorer=self.scorer,
                )
            strings = ["".join(self.labels[c] for c in r[0]) for r in results]
            offsets = [np.asarray(r[2], dtype=np.int32) for r in results]
            all_strings.append(strings)
            all_offsets.append(offsets)
        return all_strings, all_offsets
