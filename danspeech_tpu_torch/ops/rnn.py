"""Recurrent layers (GRU, LSTM, tanh RNN): the CUDA kernels on the card,
their plain versions elsewhere.

The port of ``danspeech_tpu/ops/rnn.py``. Weight layout is the JAX
package's: ``w_ih`` (I, G*H), ``w_hh`` (H, G*H) with G = 3 gates r, z, n for
the GRU (the recurrent bias b_hn inside the reset product), G = 4 gates i,
f, g, o for the LSTM and G = 1 for the tanh RNN. Rows past their length
freeze the state and emit zeros (torch ``pack_padded_sequence`` semantics).

GRU dispatch for ``impl="auto"``, as the JAX package's Pallas route:

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

The first two GRU routes with h0 = None are differentiable through
``torch.autograd.Function``s whose backward is the walk of
:func:`gru_cuda.gru_bwd_scan` per direction (the kernel on CUDA, its plain
version on the CPU or with ``impl="plain"``) followed by plain matrix
products for the weight, bias and input gradients, as the JAX package's
custom VJPs. The other GRU routes are forward-only on CUDA, as in the JAX
package: they raise there when a gradient is asked for.

:func:`lstm_layer` and :func:`rnn_tanh_layer` run one chain per direction
(:func:`lstm_cuda.lstm_scan`, :func:`rnn_tanh_cuda.rnn_tanh_scan`; the
reverse-time chain reads time backwards, no reversed copy is made), start
from zero states and return the outputs only. The LSTM chain reads the
bias-free projection in the stream dtype and adds b_ih + b_hh in f32 at
every step; the tanh chain, whose kernels have no bias operand, reads a
projection that holds both biases. The two chains of a bidirectional layer
go through :func:`lstm_cuda.lstm_scan_pair` /
:func:`rnn_tanh_cuda.rnn_tanh_scan_pair`: one launch on the card, chain by
chain on the CPU. Every shape of them (one or two directions, summed or
concatenated) is differentiable: the backward is
:func:`lstm_cuda.lstm_bwd_scan` / :func:`rnn_tanh_cuda.rnn_tanh_bwd_scan` per
direction (the two walks of a bidirectional layer through
:func:`lstm_cuda.lstm_bwd_scan_pair` / :func:`rnn_tanh_cuda.rnn_tanh_bwd_scan_pair`,
one launch on the card) followed by the same plain matrix products. An LSTM
forward that will be differentiated runs :func:`lstm_cuda.lstm_scan_with_cell`,
which also keeps the cell stream the walk needs; one that will not runs
:func:`lstm_cuda.lstm_scan`. ``impl="plain"`` runs one plain call per chain.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from ..utils.profiling import annotate
from . import gru_cuda, lstm_cuda, rnn_tanh_cuda


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
    bf16, where the JAX package keeps f32 (ROADMAP C10); a float32 product
    runs in full float32 inside the float32 modes' scope
    (``ops/precision.py``), and nothing is rounded."""
    if a.device.type == "cpu":
        return a.float() @ b.float()
    return torch.matmul(a, b).float()


def _shift_chain(seq: torch.Tensor, chain_reverse: bool) -> torch.Tensor:
    """The state before each step, in natural time order: seq[t - 1] for the
    forward chain (zeros at t = 0), seq[t + 1] for the reverse-time chain
    (zeros at t = T - 1); zeros because these layers start from zero
    states."""
    zeros = torch.zeros_like(seq[:1])
    if chain_reverse:
        return torch.cat([seq[1:], zeros])
    return torch.cat([zeros, seq[:-1]])


def _gru_walk_operands(x, lengths, w: GRUWeights, out_dir, dout, dh_last,
                       chain_reverse: bool):
    """The operands of one direction's backward walk (``gru_bwd_scan``): the
    recomputed bias-free projection, the state before each step, and the
    cotangents. Returns (operand tuple, x in the weights' dtype)."""
    x_mm = x.to(w.w_ih.dtype)
    gx = torch.matmul(x_mm, w.w_ih)  # cheaper to recompute than to save
    hprev = _shift_chain(out_dir, chain_reverse)
    return (gx.contiguous(), hprev, dout.float().contiguous(), lengths, w.w_hh,
            w.b_ih.float(), w.b_hh.float(), dh_last.float().contiguous()), x_mm


def _gru_weight_grads(x_mm, w: GRUWeights, hprev, dgx, dghn):
    """The weight, bias and input gradients of one direction as matrix
    products over the walk's streams. Returns (dx f32, GRUWeights of
    gradients in the weights' dtypes)."""
    t_max, batch, d_in = x_mm.shape
    hidden = w.w_hh.shape[0]
    mm_dtype = w.w_ih.dtype
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


def _gru_dir_grads(x, lengths, w: GRUWeights, out_dir, dout, dh_last,
                   chain_reverse: bool, impl: str):
    """Gradients of one direction: the backward walk over the recomputed
    bias-free projection, then the weight, bias and input gradients as
    matrix products over its streams (JAX ``rnn.py:_gru_dir_grads``).
    ``out_dir`` is the direction's output in the stream dtype, ``dout`` and
    ``dh_last`` the cotangents of the output and of h_last. Returns (dx f32,
    GRUWeights of gradients in the weights' dtypes)."""
    ops, x_mm = _gru_walk_operands(x, lengths, w, out_dir, dout, dh_last,
                                   chain_reverse)
    run = gru_cuda.gru_bwd_scan if impl == "auto" else gru_cuda.gru_bwd_scan_plain
    # the walk runs opposite the chain's own order
    dgx, dghn, _ = run(*ops, reverse=not chain_reverse)
    return _gru_weight_grads(x_mm, w, ops[1], dgx, dghn)


def _gru_bidi_grads(x, lengths, fwd: GRUWeights, bwd: GRUWeights, out_f, out_b,
                    d_out, d_hl, impl: str):
    """Gradients of both directions of a bidirectional layer. On the kernel
    path the two backward walks share one launch where the plan allows
    (``gru_cuda.gru_bwd_scan_pair``). Returns ((dx, grads) forward chain,
    (dx, grads) reverse-time chain), each as :func:`_gru_dir_grads`."""
    if impl != "auto":
        return (_gru_dir_grads(x, lengths, fwd, out_f, d_out, d_hl[0], False, impl),
                _gru_dir_grads(x, lengths, bwd, out_b, d_out, d_hl[1], True, impl))
    ops_f, x_mm = _gru_walk_operands(x, lengths, fwd, out_f, d_out, d_hl[0], False)
    ops_b, x_mm_b = _gru_walk_operands(x, lengths, bwd, out_b, d_out, d_hl[1], True)
    (dgx_f, dghn_f, _), (dgx_b, dghn_b, _) = gru_cuda.gru_bwd_scan_pair(
        ops_f, ops_b, reverse_a=True, reverse_b=False)
    res_f = _gru_weight_grads(x_mm, fwd, ops_f[1], dgx_f, dghn_f)
    del dgx_f, dghn_f
    return res_f, _gru_weight_grads(x_mm_b, bwd, ops_b[1], dgx_b, dghn_b)


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
        (dx_f, dfwd), (dx_b, dbwd) = _gru_bidi_grads(
            x, lengths, fwd, bwd, out_f, out_b, d_out, d_hl, ctx.impl)
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


# ---------------------------------------------------------------------------
# LSTM and tanh RNN
# ---------------------------------------------------------------------------


class LSTMWeights(NamedTuple):
    """One direction of one LSTM layer, gate order i, f, g, o."""

    w_ih: torch.Tensor  # (I, 4H)
    w_hh: torch.Tensor  # (H, 4H)
    b_ih: torch.Tensor  # (4H,)
    b_hh: torch.Tensor  # (4H,)


class RNNWeights(NamedTuple):
    """One direction of one tanh-RNN layer."""

    w_ih: torch.Tensor  # (I, H)
    w_hh: torch.Tensor  # (H, H)
    b_ih: torch.Tensor  # (H,)
    b_hh: torch.Tensor  # (H,)


def _lstm_product(x, w: LSTMWeights):
    """x @ w_ih in the weights' dtype, no bias: the stream the LSTM walks
    read (x is cast to the weights' dtype, a no-op where the caller did).
    On CUDA the product as cuBLAS returns it: bf16 accumulated in f32 and
    rounded once, float32 in full float32 inside the float32 modes' scope.
    On the CPU the f32 product of the upcast operands (see :func:`_mm`),
    rounded once to the weights' dtype."""
    x_mm = x.to(w.w_ih.dtype)
    if x_mm.device.type == "cpu":
        return _mm(x_mm, w.w_ih).to(w.w_ih.dtype)
    return torch.matmul(x_mm, w.w_ih)


def _lstm_bias(w: LSTMWeights):
    """b_ih + b_hh in f32: the LSTM walks' per-step bias, which they add to
    the bias-free projection and the recurrent product in f32. JAX
    ``_lstm_project`` puts b_ih inside a projection rounded once; here only
    the product is rounded (ROADMAP C12)."""
    return w.b_ih.float() + w.b_hh.float()


def _rnn_project(x, w: RNNWeights):
    """x @ w_ih + b_ih + b_hh in f32, rounded to the weights' dtype: the
    stream the tanh kernels read, both biases inside, as B8 and B9 have no
    bias operand (JAX ``_rnn_project``). On CUDA the bf16 product is rounded
    once before the biases are added (see :func:`_mm`), where the JAX
    package rounds only the sum (ROADMAP C12)."""
    mm_dtype = w.w_ih.dtype
    bias = w.b_ih.float() + w.b_hh.float()
    return (_mm(x.to(mm_dtype), w.w_ih) + bias).to(mm_dtype).contiguous()


def _stream_grads(x, hprev, dpre, w):
    """The weight, bias and input gradients of one direction from dpre
    (T, B, G*H) f32, the gradient of the gate pre-activations, which the
    projection and the recurrent product enter additively: matrix products
    over the streams, operands rounded to the weights' dtype (JAX
    ``_lstm_dir_grads`` / ``_rnn_dir_grads``). Returns (dx f32, gradients as
    ``type(w)`` in the weights' dtypes)."""
    t_max, batch, d_in = x.shape
    mm_dtype = w.w_ih.dtype
    rows = t_max * batch
    db = dpre.sum(dim=(0, 1))
    dpre_mm = dpre.to(mm_dtype).reshape(rows, -1)
    del dpre
    dw_hh = _mm(hprev.to(mm_dtype).reshape(rows, -1).t(), dpre_mm)
    dw_ih = _mm(x.to(mm_dtype).reshape(rows, d_in).t(), dpre_mm)
    dx = _mm(dpre_mm, w.w_ih.t()).reshape(t_max, batch, d_in)
    grads = type(w)(
        w_ih=dw_ih.to(w.w_ih.dtype), w_hh=dw_hh.to(w.w_hh.dtype),
        # both biases enter the gates additively: identical gradients
        b_ih=db.to(w.b_ih.dtype), b_hh=db.to(w.b_hh.dtype),
    )
    return dx, grads


def _lstm_walk_operands(x, lengths, w: LSTMWeights, out_dir, c_dir, dout,
                        chain_reverse: bool):
    """The operands of one LSTM direction's backward walk
    (``lstm_bwd_scan``): the recomputed bias-free projection, the shifted
    output and cell streams and the summed bias, as the forward read them."""
    return (_lstm_product(x, w), _shift_chain(out_dir, chain_reverse),
            _shift_chain(c_dir, chain_reverse), dout.float().contiguous(), lengths,
            w.w_hh, _lstm_bias(w))


def _lstm_grads(x, lengths, dirs, outs, cells, douts, impl: str):
    """Gradients of every direction of an LSTM layer: the backward walks,
    then :func:`_stream_grads` per direction. On the kernel path the two
    walks of a bidirectional layer share one launch where the plan allows
    (``lstm_cuda.lstm_bwd_scan_pair``). Returns [(dx, grads)] per
    direction."""
    x = x.to(dirs[0][0].w_ih.dtype)  # once for both directions' products
    ops = [_lstm_walk_operands(x, lengths, w, outs[k], cells[k], douts[k], rev)
           for k, (w, rev) in enumerate(dirs)]
    if impl == "auto" and len(ops) == 2:
        # the walks run opposite the chains' own order
        walks = lstm_cuda.lstm_bwd_scan_pair(ops[0], ops[1], reverse_a=True,
                                             reverse_b=False)
    else:
        run = lstm_cuda.lstm_bwd_scan if impl == "auto" else lstm_cuda.lstm_bwd_scan_plain
        walks = [run(*o, reverse=not rev) for o, (_, rev) in zip(ops, dirs)]
    return [_stream_grads(x, o[1], walk[0], w)
            for o, walk, (w, _) in zip(ops, walks, dirs)]


def _rnn_grads(x, lengths, dirs, outs, douts, impl: str):
    """Gradients of every direction of a tanh-RNN layer: the backward walks
    over the output streams, then :func:`_stream_grads` per direction. On the
    kernel path the two walks of a bidirectional layer share one launch where
    the plan allows (``rnn_tanh_cuda.rnn_tanh_bwd_scan_pair``). Returns
    [(dx, grads)] per direction."""
    ops = [(outs[k], douts[k].float().contiguous(), lengths, w.w_hh)
           for k, (w, _) in enumerate(dirs)]
    if impl == "auto" and len(ops) == 2:
        # the walks run opposite the chains' own order
        walks = rnn_tanh_cuda.rnn_tanh_bwd_scan_pair(ops[0], ops[1], reverse_a=True,
                                                     reverse_b=False)
    else:
        run = (rnn_tanh_cuda.rnn_tanh_bwd_scan if impl == "auto"
               else rnn_tanh_cuda.rnn_tanh_bwd_scan_plain)
        walks = [run(*o, reverse=not rev) for o, (_, rev) in zip(ops, dirs)]
    return [_stream_grads(x, _shift_chain(outs[k], rev), walk[0], w)
            for k, (walk, (w, rev)) in enumerate(zip(walks, dirs))]


def _directions(cls, weights):
    """[(weights of one direction, whether its chain runs in reverse time)]
    from the flat tensors a Function received."""
    dirs = [(cls(*weights[:4]), False)]
    if len(weights) > 4:
        dirs.append((cls(*weights[4:]), True))
    return dirs


def _merge_directions(outs, sum_directions: bool) -> torch.Tensor:
    outs = [o.float() for o in outs]
    if len(outs) == 1:
        return outs[0]
    return outs[0] + outs[1] if sum_directions else torch.cat(outs, dim=-1)


def _cotangents(d_out, dirs, sum_directions: bool):
    """The cotangent of each direction's output."""
    if len(dirs) == 2 and not sum_directions:
        hidden = dirs[0][0].w_hh.shape[0]
        return [d_out[..., :hidden], d_out[..., hidden:]]
    return [d_out] * len(dirs)


def _gather(x, results):
    """(dx in x's dtype, the flat weight gradients in the order the Function
    received the weights) from each direction's (dx, gradients)."""
    dx, grads = None, []
    for dx_k, dw in results:
        # on CUDA each direction's dx was rounded to bf16 by its product
        dx = dx_k if dx is None else dx + dx_k
        grads += dw
    return dx.to(x.dtype), grads


class _LSTMLayer(torch.autograd.Function):
    """One or two LSTM chains from zero states (JAX ``_pallas_lstm``).
    ``keep_cell`` picks the forward that also writes the cell streams; the
    residuals are then x, lengths, the weights and each direction's output
    and cell stream in the stream dtype. Each chain reads the bias-free
    projection as the product gives it (x cast once for both directions)
    and adds b_ih + b_hh in f32 at every step: no pass touches the gate
    stream between the GEMM and the walk. The forward marks the projections
    (``model.rnn.project``: the cast of x, the products and the summed
    biases) and the walk (``model.rnn.walk``) as spans inside the caller's
    ``model.rnn``."""

    @staticmethod
    def forward(ctx, impl, sum_directions, keep_cell, x, lengths, *weights):
        dirs = _directions(LSTMWeights, weights)
        batch, hidden = x.shape[1], weights[1].shape[0]
        zeros = torch.zeros((batch, hidden), dtype=torch.float32, device=x.device)
        if keep_cell:
            run = (lstm_cuda.lstm_scan_with_cell if impl == "auto"
                   else lstm_cuda.lstm_scan_with_cell_plain)
        else:
            run = lstm_cuda.lstm_scan if impl == "auto" else lstm_cuda.lstm_scan_plain
        with annotate("model.rnn.project"):
            x_mm = x.to(weights[0].dtype)
            chains = [((_lstm_product(x_mm, w), lengths, w.w_hh, _lstm_bias(w), zeros, zeros),
                       chain_reverse) for w, chain_reverse in dirs]
        with annotate("model.rnn.walk"):
            if impl == "auto" and len(chains) == 2:
                results = lstm_cuda.lstm_scan_pair(chains[0][0], chains[1][0], False, True,
                                                   with_cell=keep_cell)
            else:
                results = [run(*ops, reverse=chain_reverse) for ops, chain_reverse in chains]
        del chains
        outs = [res[0] for res in results]
        cells = [res[1] for res in results] if keep_cell else []
        ctx.impl, ctx.sum_directions, ctx.keep_cell = impl, sum_directions, keep_cell
        if keep_cell:
            ctx.save_for_backward(x, lengths, *outs, *cells, *weights)
        return _merge_directions(outs, sum_directions)

    @staticmethod
    @once_differentiable
    def backward(ctx, d_out):
        if not ctx.keep_cell:
            raise RuntimeError("this LSTM forward kept no cell stream")
        x, lengths, *rest = ctx.saved_tensors
        ndir = len(rest) // 6
        dirs = _directions(LSTMWeights, rest[2 * ndir :])
        dx, grads = _gather(x, _lstm_grads(
            x, lengths, dirs, rest[:ndir], rest[ndir : 2 * ndir],
            _cotangents(d_out, dirs, ctx.sum_directions), ctx.impl))
        return (None, None, None, dx, None, *grads)


class _RNNTanhLayer(torch.autograd.Function):
    """One or two tanh-RNN chains from zero states (JAX ``_pallas_rnn_tanh``):
    residuals x, lengths, the weights and each direction's output in the
    stream dtype."""

    @staticmethod
    def forward(ctx, impl, sum_directions, x, lengths, *weights):
        dirs = _directions(RNNWeights, weights)
        chains = [((_rnn_project(x, w), lengths, w.w_hh), chain_reverse)
                  for w, chain_reverse in dirs]
        if impl == "auto" and len(chains) == 2:
            results = rnn_tanh_cuda.rnn_tanh_scan_pair(chains[0][0], chains[1][0], False, True)
        else:
            run = (rnn_tanh_cuda.rnn_tanh_scan if impl == "auto"
                   else rnn_tanh_cuda.rnn_tanh_scan_plain)
            results = [run(*ops, reverse=chain_reverse) for ops, chain_reverse in chains]
        del chains
        outs = [res[0] for res in results]
        ctx.impl, ctx.sum_directions = impl, sum_directions
        ctx.save_for_backward(x, lengths, *outs, *weights)
        return _merge_directions(outs, sum_directions)

    @staticmethod
    @once_differentiable
    def backward(ctx, d_out):
        x, lengths, *rest = ctx.saved_tensors
        ndir = len(rest) // 5
        dirs = _directions(RNNWeights, rest[ndir:])
        dx, grads = _gather(x, _rnn_grads(
            x, lengths, dirs, rest[:ndir], _cotangents(d_out, dirs, ctx.sum_directions),
            ctx.impl))
        return (None, None, dx, None, *grads)


def _layer_operands(x, lengths, fwd, bwd, impl):
    """(lengths as int32 on x's device, the directions' weights as one flat
    tuple) for the LSTM and tanh Functions."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown RNN impl {impl!r}")
    lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
    return lengths, (*fwd, *bwd) if bwd is not None else tuple(fwd)


def lstm_layer(
    x: torch.Tensor,
    lengths: torch.Tensor,
    fwd: LSTMWeights,
    bwd: LSTMWeights | None = None,
    sum_directions: bool = True,
    impl: str = "auto",
) -> torch.Tensor:
    """One (optionally bidirectional) LSTM layer over (T, B, I), torch gate
    order i, f, g, o, from zero states. Returns the outputs (T, B, H) f32,
    directions summed, or (T, B, 2H) concatenated if
    ``sum_directions=False``. Differentiable in x and every weight."""
    lengths, weights = _layer_operands(x, lengths, fwd, bwd, impl)
    # what jax.custom_vjp decides by tracing: the forward that keeps the cell
    # streams runs only when a gradient will be asked for
    differentiated = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *weights)
    )
    return _LSTMLayer.apply(impl, sum_directions, differentiated, x, lengths, *weights)


def rnn_tanh_layer(
    x: torch.Tensor,
    lengths: torch.Tensor,
    fwd: RNNWeights,
    bwd: RNNWeights | None = None,
    sum_directions: bool = True,
    impl: str = "auto",
) -> torch.Tensor:
    """One (optionally bidirectional) tanh-RNN layer over (T, B, I), from a
    zero state. Returns the outputs as :func:`lstm_layer`. Differentiable in
    x and every weight."""
    lengths, weights = _layer_operands(x, lengths, fwd, bwd, impl)
    return _RNNTanhLayer.apply(impl, sum_directions, x, lengths, *weights)
