"""GRU layer: the CUDA kernel on the card, a plain recurrence elsewhere.

The port of the GRU part of ``danspeech_tpu/ops/rnn.py``. Weight layout is
the JAX package's: ``w_ih`` (I, 3H), ``w_hh`` (H, 3H), gate order r, z, n,
with the recurrent bias b_hn inside the reset product. Rows past their
length freeze h and emit zeros (torch ``pack_padded_sequence`` semantics).

Dispatch for ``impl="auto"``, as the JAX package's Pallas route:

- a bidirectional layer with summed directions and h0 = None goes through
  :func:`gru_cuda.gru_bidi_fused`;
- a unidirectional layer (h0 = None or carried), and the streaming chunk
  step :func:`gru_layer_streaming`, take a bias-free projection in the
  stream dtype and go through :func:`gru_cuda.gru_scan`;

each the kernel for CUDA tensors, its plain version for CPU tensors.
Bidirectional layers with concatenated directions or a carried h0 run the
plain recurrence on the CPU and raise on CUDA until ``gru_scan_bidi`` is
ported (ROADMAP B2). ``impl="plain"`` runs the plain versions on any
device (the counterpart of the JAX package's ``impl="xla"``); it exists to
check the kernels against them.
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
    """The JAX package's lax.scan recurrence for a bidirectional layer: both
    directions stacked, the backward one over the valid-reversed sequence,
    f32 gates and state, products on operands rounded to the weights'
    dtype."""
    t_max, batch, _ = x.shape
    hidden = fwd.w_hh.shape[0]
    directions = [fwd, bwd]
    mm_dtype = fwd.w_ih.dtype
    lengths = lengths.to(x.device)

    xs = [x, _reverse_valid(x, lengths)]
    gx = torch.stack(
        [
            torch.einsum("tbi,ik->tbk", xd.to(mm_dtype).float(), d.w_ih.float())
            + d.b_ih.float()
            for xd, d in zip(xs, directions)
        ],
        dim=1,
    )  # (T, 2, B, 3H)
    w_hh = torch.stack([d.w_hh for d in directions]).float()
    b_hh = torch.stack([d.b_hh for d in directions]).float()[:, None, :]
    if h0 is None:
        h = torch.zeros((2, batch, hidden), dtype=torch.float32, device=x.device)
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
    out = torch.stack(outs)  # (T, 2, B, H)

    out_f = out[:, 0]
    out_b = _reverse_valid(out[:, 1], lengths)
    merged = out_f + out_b if sum_directions else torch.cat([out_f, out_b], -1)
    return merged, h


def _uni_scan(x, lengths, w: GRUWeights, h0, impl: str):
    """Bias-free projection in the stream dtype (b_ih is added in the
    kernel), then one forward chain: JAX ``rnn.py`` ``_pallas_gru_uni`` and
    the carried-h0 branch of ``_gru_layer_pallas``."""
    mm_dtype = w.w_ih.dtype
    gx = torch.matmul(x.to(mm_dtype), w.w_ih)
    run = gru_cuda.gru_scan if impl == "auto" else gru_cuda.gru_scan_plain
    out, h_last = run(
        gx.contiguous(),
        lengths.to(device=x.device, dtype=torch.int32).contiguous(),
        w.w_hh, w.b_ih.float(), w.b_hh.float(), h0.float().contiguous(),
    )
    return out.float(), h_last


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
    f32, the state after each row's last valid step. ``h0`` is (D, B, H).
    """
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown GRU impl {impl!r}")
    if bwd is None:
        batch, hidden = x.shape[1], fwd.w_hh.shape[0]
        if h0 is None:
            h0_f = torch.zeros((batch, hidden), dtype=torch.float32, device=x.device)
        else:
            h0_f = h0[0]
        out, h_last = _uni_scan(x, lengths, fwd, h0_f, impl)
        return out, h_last[None]
    fused = sum_directions and h0 is None
    if impl == "auto" and x.device.type == "cuda" and not fused:
        raise NotImplementedError(
            "on CUDA, bidirectional GRU layers with concatenated directions "
            "or a carried h0 wait for the port of gru_scan_bidi (ROADMAP B2)"
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


def gru_layer_streaming(
    x: torch.Tensor,
    weights: GRUWeights,
    h0: torch.Tensor,
    t_valid: int | None = None,
    impl: str = "auto",
):
    """Unidirectional GRU chunk step with a carried state (the port of JAX
    ``rnn.py:gru_layer_streaming``). x is (T, B, I), h0 (B, H). Returns
    ((T, B, H) f32 outputs, (B, H) f32 h_last).

    ``t_valid`` (a host int) masks a zero-padded chunk: the state freezes
    and the outputs are zero past the first ``t_valid`` steps.
    """
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown GRU impl {impl!r}")
    t_max, batch, _ = x.shape
    n = t_max if t_valid is None else int(t_valid)
    lengths = torch.full((batch,), n, dtype=torch.int32, device=x.device)
    return _uni_scan(x, lengths, weights, h0, impl)
