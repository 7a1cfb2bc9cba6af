"""The work an LSTM model does, counted from the audio: four gates where
:mod:`work` counts the GRU's three. The frames, the conv stack, the layer
widths, the peaks and the bound are :mod:`work`'s.

A multiply-add is two operations; a kernel's bytes count each input byte
read once and each output byte written once; weights are inputs of each API
call, read once a call.
"""

from __future__ import annotations

import work

GATES = 4


def model_flops_per_frame(config: dict) -> float:
    """Operations of the model a frame: the convolutions, every LSTM layer's
    input and recurrent products (both directions), the head. A
    bidirectional model has no lookahead."""
    total = sum(work.conv_ops(config))
    for d, h, dirs in work.rnn_layers(config):
        total += dirs * 2 * (d + h) * GATES * h
    return total + 2 * config["rnn_hidden_size"] * len(config["labels"])


def recurrence_work(config: dict, frames: int) -> tuple:
    """(operations, bytes) of kernel B5 (``lstm_scan.cu``) in one API call
    over ``frames`` valid frames: per frame, direction and layer the product
    h (H) @ w_hh (H, 4H), the projected gx (4H) read and the output (H)
    written in the stream dtype; per call, direction and layer w_hh and its
    f32 bias read once."""
    ob = work.operand_bytes(config)
    flops = nbytes = 0
    for _, h, dirs in work.rnn_layers(config):
        flops += dirs * 2 * h * GATES * h * frames
        nbytes += dirs * (frames * (GATES * h + h) * ob + h * GATES * h * ob
                          + GATES * h * work.F32)
    return flops, nbytes


def recurrence_bound_s(config: dict, frames: int) -> float:
    """The least time B5's work in one API call takes on the card."""
    return work.bound_s(*recurrence_work(config, frames), config)
