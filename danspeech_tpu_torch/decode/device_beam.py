"""On-device vectorized CTC prefix beam search.

The port of ``danspeech_tpu.decode.device_beam``: the whole batch decodes
on the device that holds the probabilities (CUDA unless the caller asks
for the CPU) with plain torch ops — no per-utterance host loop, no
device-to-host copy of the probabilities. The JAX package's ``lax.scan``
over the frames is a Python loop over the frames here, each frame a fixed
set of tensor ops on the device; nothing in the loop reads a device value
back to the host.

Algorithm (frame-synchronous prefix beam search, reference ctcdecode
semantics, decoder.py:96-144), sort-free:

- beam state per (batch, beam): log_pb / log_pnb, last char, a pair of
  32-bit rolling prefix hashes, and the hash pair of the beam's PARENT
  prefix (the prefix minus its last char). The hashes are carried in
  ``int64`` in [0, 2**32) and reduced mod 2**32 after every multiply-add
  (decode/device_lm.py), so they equal the JAX package's ``uint32`` ones;
- each step builds W stay candidates + W x C extension candidates.
  Duplicate prefixes can arise in exactly one pattern: the extension of
  beam j by char c equals beam i's prefix iff prefix_j == prefix_i[:-1]
  and c == last_i. So the merge is a W x W parent-hash match that folds
  ext(j, last_i) into stay(i) and kills the ext entry;
- after the fold all candidates are distinct, and the top W are taken
  from the flat (B, W*(C+1)) score array. ``lax.top_k`` puts the lower
  index first among equal scores (dead slots score exactly NEG_INF, and
  the first frames are full of such ties); a stable descending sort
  followed by a slice keeps that order, so the parent and char pointers
  equal the JAX package's.

LM fusion runs on the device too: pass a decode.device_lm.DeviceLM and
word-boundary scores are probed from device-resident n-gram hash tables
inside the frame step.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .device_lm import _M32, _mul_add32

# the float32 value of the JAX package's np.float32(-1e30)
NEG_INF = float(np.float32(-1e30))

# multiplicative rolling-hash constants (odd, well-mixed 32-bit)
_H1_MUL = 0x9E3779B1
_H2_MUL = 0x85EBCA77

# hash-pair sentinels for dead beam slots: h1 = _DEAD_H1 with h2 = lane id
# keeps dead slots mutually distinct and (whp) distinct from any real
# prefix hash; _DEAD_PH1 marks "no parent" (the empty prefix and dead
# slots), which can never equal a front hash because no live front beam
# carries h1 = _DEAD_PH1.
_DEAD_H1 = 0xFFFFFFFF
_DEAD_PH1 = 0xFFFFFFFE


def _logaddexp(a, b):
    mx = torch.maximum(a, b)
    mn = torch.minimum(a, b)
    return torch.where(mx > NEG_INF / 2, mx + torch.log1p(torch.exp(mn - mx)),
                       NEG_INF)


def _top_k(x, k: int):
    """``lax.top_k`` over the last axis: the k largest, the lower index
    first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def init_front(batch: int, w: int, device=None, dtype=torch.float32):
    """Initial beam front: beam 0 is the live empty prefix, the rest are
    dead sentinel slots. Returns (pb, pnb, last, h1, h2, ph1, ph2)."""
    dev = resolve_device(device)
    lane = torch.arange(w, dtype=torch.int64, device=dev)[None, :].expand(batch, w)
    pb = torch.full((batch, w), NEG_INF, dtype=dtype, device=dev)
    pb[:, 0] = 0.0
    pnb = torch.full((batch, w), NEG_INF, dtype=dtype, device=dev)
    last = torch.full((batch, w), -1, dtype=torch.int64, device=dev)
    h1 = torch.full((batch, w), _DEAD_H1, dtype=torch.int64, device=dev)
    h1[:, 0] = 0
    h2 = lane.clone()
    h2[:, 0] = 0
    ph1 = torch.full((batch, w), _DEAD_PH1, dtype=torch.int64, device=dev)
    ph2 = lane.clone()
    return pb, pnb, last, h1, h2, ph1, ph2


def stay_ext_candidates(pb, pnb, last, lp_t, blank, topk_vals=None,
                        topk_cls=None, space=-1, bscore=None):
    """Build the step's candidates for the beam front.

    Returns (stay_pb, stay_pnb, ext) with ext of shape (B, W, K) where the
    class axis is the full C classes, or — when topk_vals/topk_cls (B, K)
    from a top-k over the frame's log-probs are given — the reference's
    ``cutoff_top_n`` per-frame class cut (ctcdecode decoder.py:96-100) with
    only the K most probable classes expanded. Under the cut the stay path
    also only contributes where blank / the last char survive the frame cut
    (the oracle cuts EVERY class). ``bscore`` (B, W), if given, is the LM
    word-boundary bonus added where the expanded class is ``space``.
    """
    num_classes = lp_t.shape[-1]
    total = _logaddexp(pb, pnb)  # (B, W)

    lp_blank = lp_t[:, blank][:, None]  # (B, 1)
    lp_last = torch.gather(lp_t, 1, last.clamp(0, num_classes - 1))  # (B, W)

    if topk_cls is not None:
        blank_in = (topk_cls == blank).any(dim=-1)[:, None]  # (B, 1)
        last_in = (topk_cls[:, None, :] == last[:, :, None]).any(dim=-1)  # (B, W)
        stay_pb = torch.where(blank_in, total + lp_blank, NEG_INF)
        stay_pnb = torch.where(last_in & (last >= 0), pnb + lp_last, NEG_INF)
        cls = topk_cls[:, None, :]  # (B, 1, K)
        vals = topk_vals[:, None, :]
    else:
        stay_pb = total + lp_blank
        stay_pnb = torch.where(last >= 0, pnb + lp_last, NEG_INF)
        cls = torch.arange(num_classes, device=lp_t.device)[None, None, :]
        vals = lp_t[:, None, :]

    # extend with class c: from total, except c == last extends only from
    # pb (the repeat-after-blank path)
    base = total[:, :, None] + vals
    rep = pb[:, :, None] + vals
    is_last = cls == last[:, :, None]
    ext = torch.where(is_last, rep, base)  # (B, W, K)
    if bscore is not None:
        ext = ext + torch.where(cls == space, bscore[:, :, None], 0.0)
    ext = torch.where(cls == blank, NEG_INF, ext)
    return stay_pb, stay_pnb, ext


def ptr_merge_select(stay_pb, stay_pnb, ext, last, h1, h2, ph1, ph2, w,
                     topk_cls=None):
    """Fold duplicate extensions into their stay candidates via the
    parent-hash match, then select the top ``w`` distinct candidates.

    All front arrays are the (B, W) front; ext is (B, W, K). Returns the
    new front (pb, pnb, last, h1, h2, ph1, ph2) plus backtrack pointers
    (parent, char), each (B, w).
    """
    batch, w_in, k = ext.shape
    num_flat = w_in * k

    # --- duplicate fold: ext(j, last_i) -> stay(i) ----------------------
    mergeable = last >= 0  # (B, W)
    pmatch = (
        (ph1[:, :, None] == h1[:, None, :])
        & (ph2[:, :, None] == h2[:, None, :])
        & mergeable[:, :, None]
    )  # (B, W_i, W_j)
    found = pmatch.any(dim=-1)
    # the first matching j (0 where none), as jnp.argmax of a bool
    j_of_i = pmatch.to(torch.int32).argmax(dim=-1)  # (B, W)
    if topk_cls is not None:
        cmatch = topk_cls[:, None, :] == last[:, :, None]  # (B, W, K)
        present = cmatch.any(dim=-1)
        c_of_i = cmatch.to(torch.int32).argmax(dim=-1)
    else:
        present = mergeable
        c_of_i = last.clamp(0, k - 1)
    can_merge = found & present  # (B, W)

    ext_flat = ext.reshape(batch, num_flat)
    gidx = j_of_i * k + c_of_i
    contrib = torch.gather(ext_flat, 1, gidx)
    stay_pnb = _logaddexp(stay_pnb, torch.where(can_merge, contrib, NEG_INF))
    # kill the folded ext entries (at most one (j, c) per i — distinct
    # beams with the same parent AND same last char would be equal); a
    # count per flat entry, so that an i that does not merge cannot undo
    # one that does at the same index
    killed = torch.zeros((batch, num_flat), dtype=torch.int32,
                         device=ext.device).scatter_add_(1, gidx, can_merge.to(torch.int32))
    ext_flat = torch.where(killed > 0, NEG_INF, ext_flat)

    # --- top-W over distinct candidates ---------------------------------
    stay_tot = _logaddexp(stay_pb, stay_pnb)
    cand = torch.cat([stay_tot, ext_flat], dim=1)
    top_val, top_idx = _top_k(cand, w)  # (B, w)
    is_stay = top_idx < w_in
    eidx = (top_idx - w_in).clamp(0, num_flat - 1)
    src = torch.where(is_stay, top_idx, eidx // k)
    kpos = eidx % k
    if topk_cls is not None:
        ch = torch.gather(topk_cls, 1, kpos)
    else:
        ch = kpos
    ch = torch.where(is_stay, -1, ch)

    g = lambda a: torch.gather(a, 1, src)  # noqa: E731
    n_pb = torch.where(is_stay, g(stay_pb), NEG_INF)
    n_pnb = torch.where(is_stay, g(stay_pnb), torch.gather(ext_flat, 1, eidx))
    hp1, hp2 = g(h1), g(h2)
    chu = (ch + 1) & _M32
    n_h1 = torch.where(is_stay, hp1, _mul_add32(hp1, _H1_MUL, chu))
    n_h2 = torch.where(is_stay, hp2, _mul_add32(hp2, _H2_MUL, chu))
    n_ph1 = torch.where(is_stay, g(ph1), hp1)
    n_ph2 = torch.where(is_stay, g(ph2), hp2)
    n_last = torch.where(is_stay, g(last), ch)

    # dead winners (filler slots while the front is still narrow) get the
    # unique sentinel hashes so they never alias a live prefix
    dead = top_val <= NEG_INF / 2
    lane = torch.arange(w, dtype=torch.int64, device=ext.device)[None, :]
    n_h1 = torch.where(dead, _DEAD_H1, n_h1)
    n_h2 = torch.where(dead, lane, n_h2)
    n_ph1 = torch.where(dead, _DEAD_PH1, n_ph1)
    n_ph2 = torch.where(dead, lane, n_ph2)
    n_last = torch.where(dead, -1, n_last)
    n_pb = torch.where(dead, NEG_INF, n_pb)
    n_pnb = torch.where(dead, NEG_INF, n_pnb)
    bk_char = torch.where(dead, -1, ch)
    return (n_pb, n_pnb, n_last, n_h1, n_h2, n_ph1, n_ph2), (src, bk_char)


def _frames_to_walk(lengths, t_max: int) -> int:
    """The frames the loop must walk: up to the longest row, read once
    (a CUDA tensor costs one synchronising read here, before the loop);
    every later frame only freezes every row."""
    if isinstance(lengths, torch.Tensor):
        longest = int(lengths.max()) if lengths.numel() else 0
    else:
        longest = int(np.max(lengths)) if len(lengths) else 0
    return max(0, min(t_max, longest))


@torch.inference_mode()
def ctc_beam_search_device(
    probs: torch.Tensor,  # (B, T, C) softmax probabilities
    lengths,  # (B,) valid frame counts: a tensor or host ints
    beam_width: int = 64,
    blank: int = 0,
    max_symbols: int | None = None,
    lm=None,  # decode.device_lm.DeviceLM for on-device LM fusion
    alpha: float = 0.0,
    beta: float = 0.0,
    space: int = -1,
    cutoff_top_n: int = 40,
    top: int | None = None,
):
    """Batched beam search on ``probs``' device. Returns (labels, times,
    lens, scores):

    labels — (B, W, T) int64, top-W label sequences (padded with -1)
    times  — (B, W, T) int64 frame index of each emitted char
    lens   — (B, W) int64 sequence lengths
    scores — (B, W) total ln-probabilities, best first

    ``top`` backtracks only the best ``top`` beams (W otherwise); the
    scores are all W. The scores are float32, as in the JAX package, except
    for float64 probabilities, which are searched in float64 (a check of
    what float32 rounding decides). With ``lm`` (a DeviceLM on the same
    device),
    word-boundary LM fusion runs inside the frame step: every space
    extension earns alpha * ln p(word | context) + beta from the hash-table
    probes, and final beams not ending in space score their trailing word.
    """
    batch, t_max, num_classes = probs.shape
    dev = probs.device
    w = beam_width
    score_dtype = torch.float64 if probs.dtype == torch.float64 else torch.float32
    log_probs = torch.log(probs.clamp_min(1e-30)).to(score_dtype)
    t_run = _frames_to_walk(lengths, t_max)
    lengths = torch.as_tensor(lengths, device=dev)

    front = init_front(batch, w, dev, score_dtype)

    if lm is not None:
        if lm.device != dev:
            raise ValueError(f"the LM tables are on {lm.device}, the "
                             f"probabilities on {dev}")
        from .device_lm import (
            boundary_scores,
            final_scores,
            init_lm_state,
            reconstruct_lm_state,
        )

        lm_state = init_lm_state(batch, w, lm.order, dev)
    else:
        lm_state = None

    use_topk = cutoff_top_n < num_classes
    lane = torch.arange(w, dtype=torch.int64, device=dev)[None, :].expand(batch, w)
    no_char = torch.full((batch, w), -1, dtype=torch.int64, device=dev)

    parents, chars = [], []
    for t in range(t_run):
        lp_t = log_probs[:, t]  # (B, C)
        if use_topk:
            topk_vals, topk_cls = _top_k(lp_t, cutoff_top_n)
        else:
            topk_vals = topk_cls = None

        if lm is not None:
            bscore, wid = boundary_scores(lm, lm_state, alpha, beta)
            if use_topk:
                # the JAX package skips the probes when no row's class cut
                # holds space (lax.cond on the whole batch); here they run
                # every frame and the cond's other branch is a mask, with
                # no read back to the host
                space_present = (topk_cls == space).any()
                bscore = torch.where(space_present, bscore, 0.0)
                wid = torch.where(space_present, wid, -1)
        else:
            bscore = None

        stay_pb, stay_pnb, ext = stay_ext_candidates(
            front[0], front[1], front[2], lp_t, blank,
            topk_vals=topk_vals, topk_cls=topk_cls,
            space=space, bscore=bscore,
        )
        new_front, (bk_parent, bk_char) = ptr_merge_select(
            stay_pb, stay_pnb, ext, *front[2:], w, topk_cls=topk_cls,
        )

        # freeze state for rows past their length; their beams keep
        # themselves with no emission
        active = (lengths > t)[:, None]
        bk_parent = torch.where(active, bk_parent, lane)
        bk_char = torch.where(active, bk_char, no_char)
        if lm is not None:
            lm_state = reconstruct_lm_state(lm_state, bk_parent, bk_char, wid, space)
        front = tuple(torch.where(active, n, o) for n, o in zip(new_front, front))
        parents.append(bk_parent)
        chars.append(bk_char)

    pb, pnb, last = front[:3]
    extra = None
    if lm is not None:
        extra = final_scores(lm, lm_state, last, alpha, beta, space)
    return backtrack_beams(pb, pnb, parents, chars, t_max, extra_scores=extra,
                           top=top)


@torch.inference_mode()
def backtrack_beams(pb, pnb, parents, chars, t_max, extra_scores=None,
                    top=None):
    """Score-sort the final beams and reconstruct label sequences + times
    by walking the per-step (parent, char) pointers backwards.

    parents/chars are (T, B, W) or the list of a (B, W) pair per walked
    frame (frames past the list froze every row: identity parents, no
    char); ``extra_scores`` (B, W), if given, is added to the CTC path
    scores before ranking (the trailing-word LM term); ``top`` limits the
    backtracked beams to the best ``top``. Returns (labels, times, lens,
    scores).
    """
    batch, w = pb.shape
    dev = pb.device
    scores = _logaddexp(pb, pnb)  # (B, W)
    if extra_scores is not None:
        scores = scores + extra_scores
    order = torch.argsort(-scores, dim=1, stable=True)
    scores = torch.gather(scores, 1, order)
    n = w if top is None else min(top, w)

    # walk parent pointers from the last walked frame with a (B, n) carry,
    # emitting each step's on-path char
    b_idx = order[:, :n]
    path = torch.full((t_max, batch, n), -1, dtype=torch.int64, device=dev)
    for t in range(len(parents) - 1, -1, -1):
        path[t] = torch.gather(chars[t], 1, b_idx)
        b_idx = torch.gather(parents[t], 1, b_idx)
    path = path.permute(1, 2, 0)  # (B, n, T), time order

    # compact the emitted (>= 0) chars to the front, preserving time
    # order, with ONE small argsort per row instead of T scatter steps
    emitted = path >= 0
    lens = emitted.sum(dim=-1)  # (B, n)
    t_idx = torch.arange(t_max, dtype=torch.int64, device=dev)
    pos = emitted.long().cumsum(dim=-1) - 1  # emission rank in time order
    key = torch.where(emitted, pos, t_max + t_idx)
    perm = torch.argsort(key, dim=-1)
    labels = torch.gather(path, -1, perm)
    times = torch.gather(t_idx.expand_as(path), -1, perm)
    valid = t_idx[None, None, :] < lens[:, :, None]
    labels = torch.where(valid, labels, -1)
    times = torch.where(valid, times, 0)
    return labels, times, lens, scores


class DeviceBeamDecoder:
    """Decoder-API wrapper over :func:`ctc_beam_search_device`.

    Same (strings, offsets) contract as BeamCTCDecoder.decode — including
    LM-fused decoding when ``lm`` is given (an NgramLM/ARPA path is packed
    into a DeviceLM on construction and stays on ``device`` across calls).
    ``device=None`` means CUDA; probabilities on another device are moved
    to this one.
    """

    def __init__(
        self,
        labels: str,
        beam_width: int = 64,
        blank_index: int = 0,
        lm=None,
        alpha: float = 0.0,
        beta: float = 0.0,
        cutoff_top_n: int = 40,
        device=None,
    ):
        self.labels = labels
        self.beam_width = beam_width
        self.blank_index = blank_index
        self.cutoff_top_n = cutoff_top_n
        self.space_index = labels.index(" ") if " " in labels else -1
        self.alpha = alpha
        self.beta = beta
        self.device = resolve_device(device)
        from .lm import coerce_device_lm

        self.lm = coerce_device_lm(lm, labels, device=self.device)

    # engine hint: decode(n_best=...) limits the beams fetched to host
    supports_n_best = True

    def decode(self, probs, sizes=None, n_best: int | None = None):
        """Decode to (strings, offsets). ``n_best`` limits how many beams
        are backtracked, converted AND fetched — a top-1 serving call
        transfers W x less than the full ctcdecode-style all-beams
        return."""
        probs = torch.as_tensor(probs).to(self.device)
        batch, t_max, _ = probs.shape
        if sizes is None:
            sizes = np.full((batch,), t_max, np.int64)
        top = self.beam_width if n_best is None else min(n_best, self.beam_width)
        labels, times, lens, _ = ctc_beam_search_device(
            probs, sizes, beam_width=self.beam_width, blank=self.blank_index,
            lm=self.lm, alpha=self.alpha, beta=self.beta,
            space=self.space_index, cutoff_top_n=self.cutoff_top_n, top=top,
        )
        return reconstruct_beam_results(
            labels, times, lens, self.labels, self.beam_width, n_best
        )


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def reconstruct_beam_results(labels, times, lens, label_str, beam_width,
                             n_best):
    """Slice beams on device, fetch, and rebuild the reference's nested
    (strings, offsets) layout."""
    top = beam_width if n_best is None else min(n_best, beam_width)
    labels = _host(labels[:, :top])
    times = _host(times[:, :top])
    lens = _host(lens[:, :top])
    all_strings, all_offsets = [], []
    for b in range(labels.shape[0]):
        strings, offsets = [], []
        for k in range(top):
            n = int(lens[b, k])
            strings.append("".join(label_str[c] for c in labels[b, k, :n]))
            offsets.append(times[b, k, :n].astype(np.int32))
        all_strings.append(strings)
        all_offsets.append(offsets)
    return all_strings, all_offsets
