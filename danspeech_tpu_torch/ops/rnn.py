"""GRU layer: the CUDA kernel on the card, a plain recurrence elsewhere.

The port of the GRU part of ``danspeech_tpu/ops/rnn.py``. Weight layout is
the JAX package's: ``w_ih`` (I, 3H), ``w_hh`` (H, 3H), gate order r, z, n,
with the recurrent bias b_hn inside the reset product. Rows past their
length freeze h and emit zeros (torch ``pack_padded_sequence`` semantics).

Dispatch for ``impl="auto"``: a bidirectional layer with summed directions
and h0 = None goes through :func:`gru_cuda.gru_bidi_fused` (the kernel for
CUDA tensors, its plain version for CPU tensors). Every other shape runs
the plain recurrence on the CPU and raises on CUDA until its kernel is
ported. ``impl="plain"`` runs the plain versions on any device (the
counterpart of the JAX package's ``impl="xla"``); it exists to check the
kernel against them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import gru_cuda


class GRUWeights(NamedTuple):
    """One direction of one GRU layer."""

    w_ih: torch.Tensor  # (I, 3H)
    w_hh: torch.Tensor  # (H, 3H)
    b_ih: torch.Tensor  # (3H,)
    b_hh: torch.Tensor  # (3H,)


def _reverse_valid(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each row's valid prefix in time: out[t] = x[len-1-t] for
    t < len; positions t >= len keep x[t]. x is (T, B, ...)."""
    t_max = x.shape[0]
    t_idx = torch.arange(t_max, device=x.device)[:, None]
    rev = lengths.to(x.device).long()[None, :] - 1 - t_idx
    idx = torch.where(rev >= 0, rev, t_idx)  # (T, B)
    idx = idx.reshape(t_max, -1, *([1] * (x.dim() - 2))).expand_as(x)
    return torch.gather(x, 0, idx)


def _gru_layer_plain(x, lengths, fwd, bwd, h0, sum_directions):
    """The JAX package's lax.scan recurrence: both directions stacked, the
    backward one over the valid-reversed sequence, f32 gates and state,
    products on operands rounded to the weights' dtype."""
    t_max, batch, _ = x.shape
    hidden = fwd.w_hh.shape[0]
    directions = [fwd] if bwd is None else [fwd, bwd]
    ndir = len(directions)
    mm_dtype = fwd.w_ih.dtype
    lengths = lengths.to(x.device)

    xs = [x] if ndir == 1 else [x, _reverse_valid(x, lengths)]
    gx = torch.stack(
        [
            torch.einsum("tbi,ik->tbk", xd.to(mm_dtype).float(), d.w_ih.float())
            + d.b_ih.float()
            for xd, d in zip(xs, directions)
        ],
        dim=1,
    )  # (T, D, B, 3H)
    w_hh = torch.stack([d.w_hh for d in directions]).float()
    b_hh = torch.stack([d.b_hh for d in directions]).float()[:, None, :]
    if h0 is None:
        h = torch.zeros((ndir, batch, hidden), dtype=torch.float32, device=x.device)
    else:
        h = h0.float()
    mask = (torch.arange(t_max, device=x.device)[:, None] < lengths[None, :]).float()

    outs = []
    for t in range(t_max):
        gh = torch.bmm(h.to(mm_dtype).float(), w_hh) + b_hh
        gx_t = gx[t]
        r = torch.sigmoid(gx_t[..., :hidden] + gh[..., :hidden])
        z = torch.sigmoid(gx_t[..., hidden : 2 * hidden] + gh[..., hidden : 2 * hidden])
        n = torch.tanh(gx_t[..., 2 * hidden :] + r * gh[..., 2 * hidden :])
        h_new = (1.0 - z) * n + z * h
        m = mask[t][None, :, None]
        h = m * h_new + (1.0 - m) * h
        outs.append(h_new * m)
    out = torch.stack(outs)  # (T, D, B, H)

    if ndir == 1:
        return out[:, 0], h
    out_f = out[:, 0]
    out_b = _reverse_valid(out[:, 1], lengths)
    merged = out_f + out_b if sum_directions else torch.cat([out_f, out_b], -1)
    return merged, h


def gru_layer(
    x: torch.Tensor,
    lengths: torch.Tensor,
    fwd: GRUWeights,
    bwd: GRUWeights | None = None,
    h0: torch.Tensor | None = None,
    sum_directions: bool = True,
    impl: str = "auto",
):
    """One (optionally bidirectional) GRU layer over (T, B, I).

    Returns (outputs, h_last): outputs (T, B, H) with directions summed, or
    (T, B, 2H) concatenated if ``sum_directions=False``; h_last (D, B, H)
    f32, the state after each row's last valid step.
    """
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown GRU impl {impl!r}")
    fused = bwd is not None and sum_directions and h0 is None
    if impl == "auto" and x.device.type == "cuda" and not fused:
        raise NotImplementedError(
            "on CUDA only bidirectional, direction-summed GRU layers with "
            "h0=None have a kernel; unidirectional, concatenated and "
            "carried-state layers wait for the ports of gru_scan and "
            "gru_scan_bidi (ROADMAP queue B1/B2)"
        )
    if not fused:
        return _gru_layer_plain(x, lengths, fwd, bwd, h0, sum_directions)

    run = gru_cuda.gru_bidi_fused if impl == "auto" else gru_cuda.gru_bidi_fused_plain
    mm_dtype = fwd.w_ih.dtype
    out_f, out_b, hl_f, hl_b = run(
        x.to(mm_dtype).contiguous(),
        lengths.to(device=x.device, dtype=torch.int32).contiguous(),
        fwd.w_ih, bwd.w_ih, fwd.w_hh, bwd.w_hh,
        fwd.b_ih, bwd.b_ih, fwd.b_hh, bwd.b_hh,
    )
    return out_f.float() + out_b.float(), torch.stack([hl_f, hl_b])
