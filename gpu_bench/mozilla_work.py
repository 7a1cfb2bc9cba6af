"""The work Mozilla DeepSpeech 0.9.3 does, counted from the audio: its
frames (one a whole MFCC window of 512 samples, hop 320), the model's
operations a frame, and kernel B5's work over them (one LSTM chain, four
gates). :mod:`work` counts DeepSpeech2's conv stack and is not used here; the
peaks and the bound are its.

A multiply-add is two operations; a kernel's bytes count each input byte
read once and each output byte written once; weights are inputs of each API
call, read once a call.
"""

from __future__ import annotations

import work

GATES = 4
WINDOW, HOP = 512, 320
N_INPUT, N_CONTEXT = 26, 9


def utterance_frames(n_samples: int) -> int:
    """Frames of an utterance: whole windows only, none below 512 samples."""
    return max(0, (n_samples - WINDOW) // HOP + 1)


def dense_widths(config: dict) -> list:
    """(in, out) of ``layer_1``, ``layer_2``, ``layer_3``, ``layer_5`` and
    ``layer_6``."""
    h = config["rnn_hidden_size"]
    return [((2 * N_CONTEXT + 1) * N_INPUT, h), (h, h), (h, h), (h, h),
            (h, len(config["labels"]))]


def model_flops_per_frame(config: dict) -> float:
    """Operations of the model a frame: the five dense products and the
    LSTM's [x; h] (2H) times its kernel (2H, 4H). The MFCC is not counted."""
    h = config["rnn_hidden_size"]
    return sum(2 * i * o for i, o in dense_widths(config)) + 2 * (2 * h) * GATES * h


def walk_work(config: dict, frames: int) -> tuple:
    """(operations, bytes) of kernel B5 in one API call over ``frames``
    valid frames: per frame the product h (H) @ w_hh (H, 4H), the projected
    gx (4H) read and the output (H) written in the stream dtype; per call
    w_hh and its f32 bias read once."""
    h = config["rnn_hidden_size"]
    ob = work.operand_bytes(config)
    flops = 2 * h * GATES * h * frames
    nbytes = frames * (GATES * h + h) * ob + h * GATES * h * ob + GATES * h * work.F32
    return flops, nbytes


def walk_bound_s(config: dict, frames: int) -> float:
    """The least time B5's work in one API call takes on the card."""
    return work.bound_s(*walk_work(config, frames), config)
