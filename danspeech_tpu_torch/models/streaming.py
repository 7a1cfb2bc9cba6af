"""Streaming (chunked, stateful) forward pass.

The port of ``danspeech_tpu/models/streaming.py``: the streaming twin of the
original DeepSpeech2 (MaskConvStream, BatchRNNStream, LookaheadStream) as
plain functions that thread a state tuple of tensors through chunk steps.
The original's quirks are kept:

- each chunk's convs still apply their own (20, 5) zero padding in time on
  top of the manual first/last 5-column pad and the 10-column left-context
  caches;
- the first chunk produces no output (the lookahead layer buffers it);
- only 2-conv streaming models are supported.

Two twins: :func:`streaming_step` follows each chunk's exact frame count;
:func:`streaming_step_masked`, which the engine uses, takes a chunk padded to
a bucketed width with its valid column count. Valid counts are host ints
(the host knows each chunk's width), so the step needs no device sync; the
state tensors live on the device of the chunk. Every GRU layer goes through
:func:`ops.rnn.gru_layer_streaming` (the ``gru_scan`` kernel on CUDA: at
B = 1, or B = S for a cohort; with float32 parameters, its float32 variant).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..errors import ConvError
from ..ops import conv as conv_ops
from ..ops import rnn as rnn_ops
from .config import CONV_SPECS, DeepSpeechConfig
from .deepspeech import Params, head


def _require_two_convs(config: DeepSpeechConfig) -> None:
    if config.conv_layers != 2:
        raise ConvError(
            "Streaming inference supports 2-conv models only (the original "
            "streaming_init hard-codes the 2-conv RNN input size)"
        )


def require_gru(config: DeepSpeechConfig) -> None:
    """Streaming is a GRU-only path, here as in the JAX package, whose
    streaming twins call its GRU chunk step whatever the model's type."""
    if config.rnn_type != "gru":
        raise NotImplementedError(
            f"rnn_type={config.rnn_type!r}: streaming supports GRU models "
            "only; the JAX package has no streaming path for LSTM or "
            "tanh-RNN models either"
        )


def _stream_convs(params: Params):
    """The two conv layers with BN folded in: [(w, b, spec), ...]."""
    return [
        (*conv_ops.fold_bn_into_conv(p), spec)
        for p, spec in zip(params["conv"][:2], CONV_SPECS[:2])
    ]


def _conv_hardtanh(x, w, b, spec):
    return conv_ops.hardtanh(
        conv_ops.conv2d(x, w, b, spec["stride"], spec["padding"])
    )


def _rnn_stack(params, x, hiddens, t_valid, rnn_impl):
    """(B, C, F, T) conv output -> (T, B, H) GRU output, new hiddens."""
    n, c, f, t = x.shape
    x = x.reshape(n, c * f, t).permute(2, 0, 1)  # (T, B, H)
    new_hiddens = []
    for entry, h0 in zip(params["rnns"], hiddens):
        if entry["bn"] is not None:
            scale, shift = entry["bn"].scale_shift()
            x = x * scale + shift
        x, h_last = rnn_ops.gru_layer_streaming(
            x, entry["fwd"], h0, t_valid=t_valid, impl=rnn_impl
        )
        new_hiddens.append(h_last)
    return x, tuple(new_hiddens)


def _probs(params, out):
    """(T, B, H) lookahead output -> (B, T, C) probabilities."""
    return torch.softmax(head(params, out).permute(1, 0, 2), dim=-1)


# ---------------------------------------------------------------------------
# Exact-shape twin
# ---------------------------------------------------------------------------


class StreamState(NamedTuple):
    """Carried streaming state (None before first use)."""

    left_1: torch.Tensor | None  # last 10 time-cols of conv1's input
    left_2: torch.Tensor | None  # last 10 time-cols of conv2's input
    hiddens: tuple  # per-RNN-layer (B, H) hidden states
    la_buffer: torch.Tensor | None  # lookahead frame buffer (T_buf, B, H)


def init_stream_state(config: DeepSpeechConfig, batch: int = 1,
                      device=None) -> StreamState:
    return StreamState(
        left_1=None,
        left_2=None,
        hiddens=tuple(
            torch.zeros((batch, config.rnn_hidden_size), device=device)
            for _ in range(config.rnn_layers)
        ),
        la_buffer=None,
    )


def _assemble(x, left_cache, is_first, is_last):
    """The original order: edge pad (left *elif* right: a first-and-last
    chunk pads only left), then prepend the 10-col cache, then snapshot the
    new cache."""
    if is_first:
        x = F.pad(x, (5, 0))
    elif is_last:
        x = F.pad(x, (0, 5))
    if not is_first:
        x = torch.cat([left_cache, x], dim=3)
    new_cache = left_cache if is_last else x[:, :, :, -10:]
    return x, new_cache


def _stream_conv(params, x, state: StreamState, is_first, is_last):
    """The two conv blocks with manual edge padding and left-context caches."""
    (w1, b1, s1), (w2, b2, s2) = _stream_convs(params)
    x, left_1 = _assemble(x, state.left_1, is_first, is_last)
    x = _conv_hardtanh(x, w1, b1, s1)
    x, left_2 = _assemble(x, state.left_2, is_first, is_last)
    x = _conv_hardtanh(x, w2, b2, s2)
    return x, left_1, left_2


def _stream_lookahead(params, x, state: StreamState, is_first, is_last):
    """LookaheadStream: buffer one chunk of frames, emit delayed output."""
    weight = params["lookahead"].weight.float()
    context = weight.shape[1]
    if is_first or state.la_buffer is None:
        return None, x  # the first chunk only fills the buffer
    out_in = torch.cat([state.la_buffer, x], dim=0)
    new_buffer = x[-(context - 1) :]
    if is_last:
        out_in = F.pad(out_in, (0, 0, 0, 0, 0, context - 1))
    # depthwise conv over time, no padding: out_len = L - context + 1
    t_out = out_in.shape[0] - context + 1
    stacked = torch.stack([out_in[k : k + t_out] for k in range(context)])
    out = torch.einsum("ctbh,hc->tbh", stacked.float(), weight)
    return conv_ops.hardtanh(out), new_buffer


@torch.inference_mode()
def streaming_step(
    params: Params,
    config: DeepSpeechConfig,
    x: torch.Tensor,
    state: StreamState,
    is_first: bool,
    is_last: bool,
    rnn_impl: str = "auto",
):
    """One chunk through conv -> GRU stack -> lookahead -> head.

    x is (1, 1, F, T_chunk). Returns (probs (1, T_out, C) or None, state').
    """
    _require_two_convs(config)
    require_gru(config)
    x, left_1, left_2 = _stream_conv(params, x, state, is_first, is_last)
    x, hiddens = _rnn_stack(params, x, state.hiddens, None, rnn_impl)
    out, la_buffer = _stream_lookahead(params, x, state, is_first, is_last)

    if is_last:
        # the stream is over: reset the recurrent, conv and lookahead state
        new_state = init_stream_state(config, batch=x.shape[1], device=x.device)
    else:
        new_state = StreamState(left_1, left_2, hiddens, la_buffer)
    if out is None:
        return None, new_state
    return _probs(params, out), new_state


# ---------------------------------------------------------------------------
# Masked (fixed-shape) twin: bucketed chunk widths
# ---------------------------------------------------------------------------


class StreamStateM(NamedTuple):
    """Fixed-shape streaming state for the masked chunk step: the caches are
    always 10 columns, the lookahead buffer a fixed-capacity ring with a
    valid-frame count (a host int)."""

    left_1: torch.Tensor  # (B, 1, F, 10) conv1 input cache
    left_2: torch.Tensor  # (B, C1, F1, 10) conv2 input cache
    hiddens: tuple  # per-RNN-layer (B, H) f32 hidden states
    la_buffer: torch.Tensor  # (cap, B, H) lookahead frame buffer
    buf_len: int  # valid frames in la_buffer


# headroom the engine leaves between a chunk's valid frames and its padded
# width: 5 cols of is_last edge padding at each conv plus slack, so every
# conv output's valid region fits the physical array
CHUNK_HEADROOM = 12


def conv1_out_frames(t: int) -> int:
    """Physical conv1 output columns for a t-column input (stride 2)."""
    return (t + 2 * CONV_SPECS[0]["padding"][1] - CONV_SPECS[0]["kernel"][1]) // 2 + 1


def phys_rnn_frames(tp_spect: int, is_first: bool) -> int:
    """Physical RNN frame count of a masked chunk step for a padded
    spectrogram width ``tp_spect`` (conv2 preserves length; the caches and
    edge pads add static columns)."""
    t1_in = tp_spect + (5 if is_first else 10 + 5)
    t1 = conv1_out_frames(t1_in)
    return t1 + (5 if is_first else 10 + 5)


def init_stream_state_masked(config: DeepSpeechConfig, buf_cap: int,
                             batch: int = 1, device=None) -> StreamStateM:
    # the lookahead buffer holds at least context-1 frames, whatever the
    # first chunk's width
    if not config.bidirectional:
        buf_cap = max(buf_cap, config.context - 1)
    spec = CONV_SPECS[0]
    f1 = (config.n_freq + 2 * spec["padding"][0] - spec["kernel"][0]) // 2 + 1
    hidden = config.rnn_hidden_size
    return StreamStateM(
        left_1=torch.zeros((batch, 1, config.n_freq, 10), device=device),
        left_2=torch.zeros((batch, spec["out"], f1, 10), device=device),
        hiddens=tuple(
            torch.zeros((batch, hidden), dtype=torch.float32, device=device)
            for _ in range(config.rnn_layers)
        ),
        la_buffer=torch.zeros((buf_cap, batch, hidden), device=device),
        buf_len=0,
    )


def _mask_cols(x: torch.Tensor, valid: int) -> torch.Tensor:
    """Zero the time columns at index >= valid (last axis)."""
    keep = torch.arange(x.shape[-1], device=x.device) < valid
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))


def _assemble_masked(x, valid: int, cache, is_first, is_last):
    """Masked twin of the edge-pad + cache logic: x is (B, C, F, Tp) with
    zeros at columns >= valid. Returns (assembled x, new valid count, new
    10-col cache). The is_last right pad moves no data: the zeros are in
    place, the valid count grows (the array gets 5 more zero columns)."""
    if is_first:
        x = F.pad(x, (5, 0))
        valid += 5
    elif is_last:
        x = F.pad(x, (0, 5))
        valid += 5
    if not is_first:
        x = torch.cat([cache, x], dim=3)
        valid += 10
    if is_last:
        new_cache = cache
    else:
        # lax.dynamic_slice clamps the start so the slice fits
        start = min(max(valid - 10, 0), x.shape[3] - 10)
        new_cache = x[:, :, :, start : start + 10]
    return x, valid, new_cache


def _stream_conv_masked(params, x, valid: int, state: StreamStateM,
                        is_first, is_last):
    (w1, b1, s1), (w2, b2, s2) = _stream_convs(params)
    x, valid, left_1 = _assemble_masked(x, valid, state.left_1, is_first, is_last)
    x = _conv_hardtanh(x, w1, b1, s1)
    valid = (valid - 1) // 2 + 1  # stride-2 time downsample
    # columns past valid saw only zeros, but BN + hardtanh made them
    # nonzero: zero them so conv2 sees the exact-shape path's zero padding
    x = _mask_cols(x, valid)
    x, valid, left_2 = _assemble_masked(x, valid, state.left_2, is_first, is_last)
    x = _conv_hardtanh(x, w2, b2, s2)
    # conv2 keeps the time length (kernel 11, pad 5, stride 1)
    return _mask_cols(x, valid), valid, left_1, left_2


def _stream_lookahead_masked(params, x, valid: int, state: StreamStateM,
                             is_first, is_last):
    """Masked LookaheadStream: fixed-capacity frame buffer + valid count.

    x is (Tp, B, H) with rows >= valid zeroed. Returns (out (T_out_phys, B,
    H) or None, out_len, new buffer, new buffer length).
    """
    weight = params["lookahead"].weight.float()
    context = weight.shape[1]
    cap = state.la_buffer.shape[0]
    tp, batch, hidden = x.shape

    if is_first:
        # the original buffers the whole first chunk
        if tp >= cap:
            new_buffer = x[:cap]
        else:
            new_buffer = torch.cat([x, x.new_zeros((cap - tp, batch, hidden))])
        return None, 0, new_buffer, valid

    buf_len = state.buf_len
    pad_tail = context - 1 if is_last else 0
    combined = x.new_zeros((cap + tp + pad_tail, batch, hidden))
    combined[:cap] = state.la_buffer
    start = min(buf_len, cap + pad_tail)  # dynamic_update_slice clamps
    combined[start : start + tp] = x
    total_valid = buf_len + valid

    t_out = combined.shape[0] - context + 1
    stacked = torch.stack([combined[k : k + t_out] for k in range(context)])
    out = conv_ops.hardtanh(torch.einsum("ctbh,hc->tbh", stacked, weight))
    out_len = total_valid if is_last else max(total_valid - (context - 1), 0)

    # next buffer: the last context-1 valid frames of x (fewer when the
    # chunk is shorter, like the original's shrinking buffer)
    start = min(max(valid - (context - 1), 0), tp - (context - 1))
    new_buf_len = min(valid, context - 1)
    new_buffer = x.new_zeros((cap, batch, hidden))
    new_buffer[:new_buf_len] = x[start : start + new_buf_len]
    return out, out_len, new_buffer, new_buf_len


@torch.inference_mode()
def streaming_step_masked(
    params: Params,
    config: DeepSpeechConfig,
    x: torch.Tensor,
    t_valid: int,
    state: StreamStateM,
    is_first: bool,
    is_last: bool,
    rnn_impl: str = "auto",
):
    """Fixed-shape twin of :func:`streaming_step`.

    x is (1, 1, F, Tp) zero-padded to a bucketed width Tp with ``t_valid``
    real columns (Tp - t_valid >= CHUNK_HEADROOM). Returns (probs (1,
    T_out_phys, C) or None, out_len, state'); the caller slices
    probs[:, :out_len].
    """
    _require_two_convs(config)
    require_gru(config)
    x, valid, left_1, left_2 = _stream_conv_masked(
        params, x, int(t_valid), state, is_first, is_last
    )
    x, hiddens = _rnn_stack(params, x, state.hiddens, valid, rnn_impl)
    out, out_len, la_buffer, buf_len = _stream_lookahead_masked(
        params, x, valid, state, is_first, is_last
    )

    if is_last:
        new_state = init_stream_state_masked(
            config, buf_cap=state.la_buffer.shape[0], batch=x.shape[1],
            device=x.device,
        )
    else:
        new_state = StreamStateM(left_1, left_2, hiddens, la_buffer, buf_len)
    if out is None:
        return None, out_len, new_state
    return _probs(params, out), out_len, new_state
