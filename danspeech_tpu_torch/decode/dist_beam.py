"""Beam-parallel CTC prefix beam search over a mesh axis.

The port of ``danspeech_tpu/decode/dist_beam.py`` on the frame step of
:mod:`.device_beam`. Every rank holds the whole (B, T, C) log-probabilities
and the whole beam front; at each frame rank ``k`` of ``n`` builds the stay
and extension candidates (and probes the device LM) for its ``W/n`` slice of
the beam only, one ``all_gather`` over the axis reassembles the candidate
scores (and the slice's word ids) in global beam order, and every rank runs
the same global parent-pointer merge and top-W selection
(:func:`device_beam.ptr_merge_select`), so the pruned front stays replicated
with no leader. The frame's ``cutoff_top_n`` class cut comes from the
replicated log-probs, so every rank expands the same K classes.

Candidates depend on their own beam only, so the gathered arrays equal the
single-device ones element for element and the front equals
:func:`device_beam.ctc_beam_search_device`'s bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import DATA_AXIS, Mesh, all_gather, axis_index
from .device_beam import (
    _frames_to_walk,
    _top_k,
    backtrack_beams,
    init_front,
    ptr_merge_select,
    reconstruct_beam_results,
    stay_ext_candidates,
)


def _gather_candidates(stay_pb, stay_pnb, ext, wid, mesh, axis):
    """The ranks' (B, W/n) stay scores, (B, W/n, K) extension scores and
    (B, W/n) word ids, concatenated along the beam in rank order by ONE
    all_gather of a float64 pack (exact for float32 scores and the ids)."""
    batch, w_local, k = ext.shape
    parts = [stay_pb[..., None], stay_pnb[..., None], ext]
    if wid is not None:
        parts.append(wid[..., None])
    pack = torch.cat([p.double() for p in parts], dim=-1)
    pack = all_gather(pack, mesh, axis, dim=1)
    dtype = stay_pb.dtype
    wid_all = pack[..., 2 + k].long() if wid is not None else None
    return pack[..., 0].to(dtype), pack[..., 1].to(dtype), pack[..., 2 : 2 + k].to(dtype), wid_all


@torch.inference_mode()
def ctc_beam_search_beam_sharded(
    probs: torch.Tensor,  # (B, T, C) softmax probabilities, on every rank
    lengths,  # (B,)
    mesh: Mesh,
    axis: str = DATA_AXIS,
    beam_width: int = 64,
    blank: int = 0,
    lm=None,  # decode.device_lm.DeviceLM on the mesh's device
    alpha: float = 0.0,
    beta: float = 0.0,
    space: int = -1,
    cutoff_top_n: int = 40,
    top: int | None = None,
):
    """Beam-sharded search over ``mesh``'s ``axis``. Returns (labels, times,
    lens, scores) as :func:`device_beam.ctc_beam_search_device`, with the
    same values, on every rank."""
    n = mesh.size(axis)
    if beam_width % n:
        raise ValueError(f"beam_width {beam_width} must divide over {n} shards")
    dev = mesh.device
    probs = torch.as_tensor(probs).to(dev)
    batch, t_max, num_classes = probs.shape
    w = beam_width
    w_local = w // n
    lo = axis_index(mesh, axis) * w_local
    sl = slice(lo, lo + w_local)
    score_dtype = torch.float64 if probs.dtype == torch.float64 else torch.float32
    log_probs = torch.log(probs.clamp_min(1e-30)).to(score_dtype)
    t_run = _frames_to_walk(lengths, t_max)
    lengths = torch.as_tensor(lengths, device=dev)

    front = init_front(batch, w, dev, score_dtype)
    if lm is not None:
        if lm.device != dev:
            raise ValueError(f"the LM tables are on {lm.device}, the mesh on {dev}")
        from .device_lm import (
            boundary_scores,
            final_scores,
            init_lm_state,
            reconstruct_lm_state,
        )

        lm_state = init_lm_state(batch, w, lm.order, dev)
    use_topk = cutoff_top_n < num_classes
    lane = torch.arange(w, dtype=torch.int64, device=dev)[None, :].expand(batch, w)
    no_char = torch.full((batch, w), -1, dtype=torch.int64, device=dev)

    parents, chars = [], []
    for t in range(t_run):
        lp_t = log_probs[:, t]
        topk_vals, topk_cls = _top_k(lp_t, cutoff_top_n) if use_topk else (None, None)
        bscore = wid_local = None
        if lm is not None:
            # probe the LM for this rank's beam slice only
            bscore, wid_local = boundary_scores(
                lm, tuple(a[:, sl] for a in lm_state), alpha, beta)
            if use_topk:
                space_present = (topk_cls == space).any()
                bscore = torch.where(space_present, bscore, 0.0)
                wid_local = torch.where(space_present, wid_local, -1)
        stay_pb, stay_pnb, ext = stay_ext_candidates(
            front[0][:, sl], front[1][:, sl], front[2][:, sl], lp_t, blank,
            topk_vals=topk_vals, topk_cls=topk_cls, space=space, bscore=bscore,
        )
        stay_pb, stay_pnb, ext, wid = _gather_candidates(
            stay_pb, stay_pnb, ext, wid_local, mesh, axis)
        # the same global merge on every rank keeps the front replicated
        new_front, (bk_parent, bk_char) = ptr_merge_select(
            stay_pb, stay_pnb, ext, *front[2:], w, topk_cls=topk_cls,
        )
        active = (lengths > t)[:, None]
        bk_parent = torch.where(active, bk_parent, lane)
        bk_char = torch.where(active, bk_char, no_char)
        if lm is not None:
            lm_state = reconstruct_lm_state(lm_state, bk_parent, bk_char, wid, space)
        front = tuple(torch.where(active, a, b) for a, b in zip(new_front, front))
        parents.append(bk_parent)
        chars.append(bk_char)

    pb, pnb, last = front[:3]
    extra = final_scores(lm, lm_state, last, alpha, beta, space) if lm is not None else None
    return backtrack_beams(pb, pnb, parents, chars, t_max, extra_scores=extra, top=top)


class ShardedBeamDecoder:
    """Decoder-API wrapper over :func:`ctc_beam_search_beam_sharded`.

    Same (strings, offsets) contract as BeamCTCDecoder.decode and the
    DeviceBeamDecoder, with the beam front sharded over ``mesh``'s data
    axis; reachable from the public API through
    ``Recognizer.update_decoder(backend="sharded", mesh=...)``. Every rank of
    the axis must call :meth:`decode` with the same probabilities.
    """

    def __init__(
        self,
        labels: str,
        mesh: Mesh,
        axis: str = DATA_AXIS,
        beam_width: int = 64,
        blank_index: int = 0,
        lm=None,
        alpha: float = 0.0,
        beta: float = 0.0,
        cutoff_top_n: int = 40,
    ):
        if beam_width % mesh.size(axis):
            raise ValueError(
                f"beam_width {beam_width} must divide over {mesh.size(axis)} shards")
        self.labels = labels
        self.mesh = mesh
        self.axis = axis
        self.beam_width = beam_width
        self.blank_index = blank_index
        self.cutoff_top_n = cutoff_top_n
        self.space_index = labels.index(" ") if " " in labels else -1
        self.alpha = alpha
        self.beta = beta
        from .lm import coerce_device_lm

        self.lm = coerce_device_lm(lm, labels, device=mesh.device)

    supports_n_best = True

    def decode(self, probs, sizes=None, n_best: int | None = None):
        probs = torch.as_tensor(probs).to(self.mesh.device)
        batch, t_max, _ = probs.shape
        if sizes is None:
            sizes = np.full((batch,), t_max, np.int64)
        top = self.beam_width if n_best is None else min(n_best, self.beam_width)
        labels, times, lens, _ = ctc_beam_search_beam_sharded(
            probs, sizes, self.mesh, axis=self.axis,
            beam_width=self.beam_width, blank=self.blank_index,
            lm=self.lm, alpha=self.alpha, beta=self.beta,
            space=self.space_index, cutoff_top_n=self.cutoff_top_n, top=top,
        )
        return reconstruct_beam_results(
            labels, times, lens, self.labels, self.beam_width, n_best
        )
