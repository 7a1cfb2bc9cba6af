"""GRU layer: the CUDA kernels on the card, their plain versions elsewhere.

The port of the GRU part of ``danspeech_tpu/ops/rnn.py``. Weight layout is
the JAX package's: ``w_ih`` (I, 3H), ``w_hh`` (H, 3H), gate order r, z, n,
with the recurrent bias b_hn inside the reset product. Rows past their
length freeze h and emit zeros (torch ``pack_padded_sequence`` semantics).

Dispatch for ``impl="auto"``, as the JAX package's Pallas route:

- a bidirectional layer with summed directions and h0 = None goes through
  :func:`gru_cuda.gru_bidi_fused`, whatever its width (the JAX package
  leaves this route when the four weight matrices exceed 72 MB, which is a
  budget of the TPU's VMEM and has no meaning on this card);
- a unidirectional layer (h0 = None or carried), and the streaming chunk
  step :func:`gru_layer_streaming`, take a bias-free projection in the
  stream dtype and go through :func:`gru_cuda.gru_scan`;
- a bidirectional layer with concatenated directions or a carried h0 takes
  one bias-free projection per direction and goes through
  :func:`gru_cuda.gru_scan_bidi`;

each the kernel for CUDA tensors, its plain version for CPU tensors.
``impl="plain"`` runs the plain versions on any device (the counterpart of
the JAX package's ``impl="xla"``); it exists to check the kernels against
them.

The first two routes with h0 = None are differentiable through
``torch.autograd.Function``s whose backward is the walk of
:func:`gru_cuda.gru_bwd_scan` per direction (the kernel on CUDA, its plain
version on the CPU or with ``impl="plain"``) followed by plain matrix
products for the weight, bias and input gradients, as the JAX package's
custom VJPs. The other routes are forward-only on CUDA, as in the JAX
package: they raise there when a gradient is asked for.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from . import gru_cuda


class GRUWeights(NamedTuple):
    """One direction of one GRU layer."""

    w_ih: torch.Tensor  # (I, 3H)
    w_hh: torch.Tensor  # (H, 3H)
    b_ih: torch.Tensor  # (3H,)
    b_hh: torch.Tensor  # (3H,)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b on operands of one dtype with an f32 result. On the CPU the
    operands are upcast first (a bf16 matmul there rounds its result); on
    CUDA a bf16 product accumulates in f32 and its result is rounded to
    bf16, where the JAX package keeps f32."""
    if a.device.type == "cpu":
        return a.float() @ b.float()
    return torch.matmul(a, b).float()


def _gru_dir_grads(x, lengths, w: GRUWeights, out_dir, dout, dh_last,
                   chain_reverse: bool, impl: str):
    """Gradients of one direction: the backward walk over the recomputed
    bias-free projection, then the weight, bias and input gradients as
    matrix products over its streams (JAX ``rnn.py:_gru_dir_grads``).
    ``out_dir`` is the direction's output in the stream dtype, ``dout`` and
    ``dh_last`` the cotangents of the output and of h_last. Returns (dx f32,
    GRUWeights of gradients in the weights' dtypes)."""
    t_max, batch, d_in = x.shape
    hidden = w.w_hh.shape[0]
    mm_dtype = w.w_ih.dtype
    x_mm = x.to(mm_dtype)
    gx = torch.matmul(x_mm, w.w_ih)  # cheaper to recompute than to save
    zeros = out_dir.new_zeros((1, batch, hidden))
    if chain_reverse:
        # the state before step t is the state after step t + 1; the chain
        # starts from zeros at t = T - 1
        hprev = torch.cat([out_dir[1:], zeros])
    else:
        hprev = torch.cat([zeros, out_dir[:-1]])
    run = gru_cuda.gru_bwd_scan if impl == "auto" else gru_cuda.gru_bwd_scan_plain
    dgx, dghn, _ = run(
        gx.contiguous(), hprev, dout.float().contiguous(), lengths, w.w_hh,
        w.b_ih.float(), w.b_hh.float(), dh_last.float().contiguous(),
        # the walk runs opposite the chain's own order
        reverse=not chain_reverse,
    )
    db_ih = dgx.sum(dim=(0, 1))
    db_hh = torch.cat([db_ih[: 2 * hidden], dghn.sum(dim=(0, 1))])
    dgx_mm = dgx.to(mm_dtype).reshape(t_max * batch, 3 * hidden)
    dgh_mm = torch.cat([dgx_mm[:, : 2 * hidden],
                        dghn.to(mm_dtype).reshape(t_max * batch, hidden)], dim=1)
    del dgx, dghn
    dw_hh = _mm(hprev.to(mm_dtype).reshape(t_max * batch, hidden).t(), dgh_mm)
    del dgh_mm
    dw_ih = _mm(x_mm.reshape(t_max * batch, d_in).t(), dgx_mm)
    dx = _mm(dgx_mm, w.w_ih.t()).reshape(t_max, batch, d_in)
    grads = GRUWeights(
        w_ih=dw_ih.to(w.w_ih.dtype), w_hh=dw_hh.to(w.w_hh.dtype),
        b_ih=db_ih.to(w.b_ih.dtype), b_hh=db_hh.to(w.b_hh.dtype),
    )
    return dx, grads


class _GRUBidiSum(torch.autograd.Function):
    """Bidirectional layer with summed directions, h0 = 0 (JAX
    ``_pallas_gru_bidi_sum``): residuals x, lengths, the weights and the two
    directions' outputs in the stream dtype."""

    @staticmethod
    def forward(ctx, impl, x, lengths, *weights):
        fwd, bwd = GRUWeights(*weights[:4]), GRUWeights(*weights[4:])
        run = gru_cuda.gru_bidi_fused if impl == "auto" else gru_cuda.gru_bidi_fused_plain
        out_f, out_b, hl_f, hl_b = run(
            x.to(fwd.w_ih.dtype).contiguous(), lengths,
            fwd.w_ih, bwd.w_ih, fwd.w_hh, bwd.w_hh,
            fwd.b_ih, bwd.b_ih, fwd.b_hh, bwd.b_hh,
        )
        ctx.impl = impl
        ctx.save_for_backward(x, lengths, out_f, out_b, *weights)
        return out_f.float() + out_b.float(), torch.stack([hl_f, hl_b])

    @staticmethod
    @once_differentiable
    def backward(ctx, d_out, d_hl):
        x, lengths, out_f, out_b, *weights = ctx.saved_tensors
        fwd, bwd = GRUWeights(*weights[:4]), GRUWeights(*weights[4:])
        dx_f, dfwd = _gru_dir_grads(x, lengths, fwd, out_f, d_out, d_hl[0],
                                    False, ctx.impl)
        dx_b, dbwd = _gru_dir_grads(x, lengths, bwd, out_b, d_out, d_hl[1],
                                    True, ctx.impl)
        return (None, (dx_f + dx_b).to(x.dtype), None, *dfwd, *dbwd)


class _GRUUni(torch.autograd.Function):
    """Unidirectional layer, h0 = 0 (JAX ``_pallas_gru_uni``): residuals x,
    lengths, the weights and the output in the stream dtype."""

    @staticmethod
    def forward(ctx, impl, x, lengths, *weights):
        w = GRUWeights(*weights)
        h0 = torch.zeros((x.shape[1], w.w_hh.shape[0]), dtype=torch.float32,
                         device=x.device)
        out, h_last = _uni_scan(x, lengths, w, h0, impl)
        ctx.impl = impl
        ctx.save_for_backward(x, lengths, out, *weights)
        return out.float(), h_last[None]

    @staticmethod
    @once_differentiable
    def backward(ctx, d_out, d_hl):
        x, lengths, out, *weights = ctx.saved_tensors
        dx, dw = _gru_dir_grads(x, lengths, GRUWeights(*weights), out, d_out,
                                d_hl[0], False, ctx.impl)
        return (None, dx.to(x.dtype), None, *dw)


def _uni_scan(x, lengths, w: GRUWeights, h0, impl: str):
    """Bias-free projection in the stream dtype (b_ih is added in the
    kernel), then one forward chain: JAX ``rnn.py`` ``_pallas_gru_uni`` and
    the carried-h0 branch of ``_gru_layer_pallas``. Returns (out in the
    stream dtype, h_last f32)."""
    gx = torch.matmul(x.to(w.w_ih.dtype), w.w_ih)
    run = gru_cuda.gru_scan if impl == "auto" else gru_cuda.gru_scan_plain
    return run(
        gx.contiguous(), lengths, w.w_hh, w.b_ih.float(), w.b_hh.float(),
        h0.float().contiguous(),
    )


def _forward_only(x, *weights) -> None:
    """The carried-h0 and concatenated routes have no backward kernel."""
    if (x.device.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, *weights))):
        raise NotImplementedError(
            "on CUDA, GRU layers with a carried h0 or concatenated directions "
            "are forward-only (as in the JAX package): no backward kernel"
        )


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
    lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
    if bwd is None:
        if h0 is None:
            return _GRUUni.apply(impl, x, lengths, *fwd)
        _forward_only(x, *fwd)
        out, h_last = _uni_scan(x, lengths, fwd, h0[0], impl)
        return out.float(), h_last[None]
    if sum_directions and h0 is None:
        return _GRUBidiSum.apply(impl, x, lengths, *fwd, *bwd)

    _forward_only(x, *fwd, *bwd)
    batch, hidden = x.shape[1], fwd.w_hh.shape[0]
    if h0 is None:
        h0 = torch.zeros((2, batch, hidden), dtype=torch.float32, device=x.device)
    x_mm = x.to(fwd.w_ih.dtype)
    run = gru_cuda.gru_scan_bidi if impl == "auto" else gru_cuda.gru_scan_bidi_plain
    out_f, out_b, hl_f, hl_b = run(
        torch.matmul(x_mm, fwd.w_ih).contiguous(),
        torch.matmul(x_mm, bwd.w_ih).contiguous(),
        lengths, fwd.w_hh, bwd.w_hh,
        fwd.b_ih.float(), bwd.b_ih.float(), fwd.b_hh.float(), bwd.b_hh.float(),
        h0[0].float().contiguous(), h0[1].float().contiguous(),
    )
    out_f, out_b = out_f.float(), out_b.float()
    merged = out_f + out_b if sum_directions else torch.cat([out_f, out_b], -1)
    return merged, torch.stack([hl_f, hl_b])


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
    out, h_last = _uni_scan(x, lengths, weights, h0, impl)
    return out.float(), h_last
