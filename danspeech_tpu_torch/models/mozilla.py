"""Mozilla DeepSpeech (v0.9.3) acoustic model as a parameter tree + plain
functions: the second family the port serves, beside DeepSpeech2
(:mod:`.deepspeech`).

The graph of ``training/deepspeech_training/train.py`` ``create_model``
(Coqui STT 1.x serves the same): the MFCC front end (:mod:`..ops.mfcc`),
``create_overlapping_windows`` (frame t becomes its 19 neighbours [f(t - 9),
..., f(t + 9)], zeros outside the utterance), three dense layers (``layer_1``
494 -> H, ``layer_2`` and ``layer_3`` H -> H, each x W + b clipped to [0,
20]), one unidirectional LSTM of H units (``LSTMBlockFusedCell``,
``forget_bias=0``, no peepholes, no cell clip; states frozen past a row's
length), ``layer_5`` H -> H with the same clip, ``layer_6`` H -> classes
linear, then softmax. The labels put CTC's blank last: 28 characters of
``data/alphabet.txt`` (space, a-z, apostrophe), then ``_``.

The parameter tree keeps the release's layouts: each dense layer's ``weight``
(in, out) and ``bias`` (out,); the LSTM as :class:`~..ops.rnn.LSTMWeights`
(w_ih (I, 4H), w_hh (H, 4H) in the port's gate order i, f, g, o, with the
release's single bias as ``b_ih`` and zeros as ``b_hh``: the walk adds their
sum at every step). ``models/checkpoint.py`` reads and writes the release's
variable names (:data:`LSTM_KERNEL`, :data:`LSTM_BIAS`, ``layer_k/weights``,
``layer_k/bias``).

The windows are materialised: the (T, B, 19 x 32) window tensor, one copy,
feeds ``layer_1`` as one product (:func:`windows`). Each frame's 26
coefficients are padded with zeros to 32 (:data:`FEATURE_WIDTH`), so that a
window row is 608 values, a multiple of 8, as cuBLAS's tensor-core products
want, and :func:`compute_params` gives ``layer_1`` zero rows to match.

On CUDA with bf16 compute the dense layers are bf16 products (cuBLAS, f32
accumulation, the bias added in the product's epilogue, the result rounded
once to bf16), the LSTM goes through :func:`..ops.rnn.lstm_layer` (kernel
B5, ``lstm_scan``: the persistent walk where its plan fits, else one launch
a step), and ``layer_6`` multiplies bf16-rounded operands in float32, as
DeepSpeech2's head does. Spans: ``model.features`` (the MFCC),
``model.context`` (the windows), ``model.dense`` (layers 1-3),
``model.rnn`` (with the LSTM's ``model.rnn.project`` and
``model.rnn.walk``) and ``model.head`` (layers 5 and 6, the softmax).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import mfcc as mfcc_ops
from ..ops import rnn as rnn_ops
from ..utils.profiling import annotate

FAMILY = "mozilla"
N_INPUT = mfcc_ops.COEFFICIENTS  # 26
N_CONTEXT = 9
WINDOW_FRAMES = 2 * N_CONTEXT + 1  # 19
FEATURE_WIDTH = 32  # coefficients a frame, zero-padded from 26
RELU_CLIP = 20.0
LABELS = " abcdefghijklmnopqrstuvwxyz'_"
AUDIO_CONF = {"normalize": False, "sampling_rate": mfcc_ops.SAMPLE_RATE, "window": "hann",
              "window_size": mfcc_ops.WINDOW / mfcc_ops.SAMPLE_RATE,
              "window_stride": mfcc_ops.HOP / mfcc_ops.SAMPLE_RATE}
# the release's variable names of the LSTM (train.py rnn_impl_lstmblockfusedcell)
LSTM_SCOPE = "cudnn_lstm/rnn/multi_rnn_cell/cell_0/cudnn_compatible_lstm_cell"
LSTM_KERNEL = f"{LSTM_SCOPE}/kernel"
LSTM_BIAS = f"{LSTM_SCOPE}/bias"
DENSE = ("layer_1", "layer_2", "layer_3", "layer_5", "layer_6")
# the port's gates i, f, g, o as blocks of TensorFlow's i, c~, f, o (and the
# reverse)
TF_GATE_BLOCKS = (0, 2, 1, 3)


class Dense(NamedTuple):
    """One dense layer: x @ weight + bias."""

    weight: torch.Tensor  # (in, out)
    bias: torch.Tensor    # (out,)


def reorder_gates(t, hidden: int):
    """The last axis of ``t`` (4H, a numpy array or a tensor) from
    TensorFlow's gate blocks i, c~, f, o to the port's i, f, g, o, and back:
    the swap of the middle two blocks is its own inverse."""
    parts = [t[..., b * hidden : (b + 1) * hidden] for b in TF_GATE_BLOCKS]
    if isinstance(t, torch.Tensor):
        return torch.cat(parts, dim=-1)
    return np.concatenate(parts, axis=-1)


def init_params(config, seed: int = 0, dtype=torch.float32) -> dict:
    """Random parameters as the release initialises them: Glorot-uniform
    kernels (the dense layers' VarianceScaling(fan_avg, uniform) and the
    LSTM kernel's default), zero biases. Drawn from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    hidden = config.rnn_hidden_size

    def glorot(fan_in, fan_out):
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        w = rng.uniform(-bound, bound, size=(fan_in, fan_out)).astype(np.float32)
        return torch.from_numpy(w).to(dtype)

    def dense(fan_in, fan_out):
        return Dense(weight=glorot(fan_in, fan_out), bias=torch.zeros(fan_out, dtype=dtype))

    kernel = glorot(2 * hidden, 4 * hidden)  # rows [x; h], one matrix as in the release
    kernel = reorder_gates(kernel, hidden)
    zeros = torch.zeros(4 * hidden, dtype=dtype)
    return {
        "layer_1": dense(WINDOW_FRAMES * N_INPUT, hidden),
        "layer_2": dense(hidden, hidden),
        "layer_3": dense(hidden, hidden),
        "lstm": rnn_ops.LSTMWeights(w_ih=kernel[:hidden].contiguous(),
                                    w_hh=kernel[hidden:].contiguous(), b_ih=zeros,
                                    b_hh=zeros.clone()),
        "layer_5": dense(hidden, hidden),
        "layer_6": dense(hidden, config.num_classes),
    }


def compute_params(params: dict, dtype=torch.float32) -> dict:
    """The tree :func:`forward` takes: ``layer_1``'s rows spread to 19 frames
    of :data:`FEATURE_WIDTH` (zero rows for the padded coefficients), the
    products' weights in ``dtype`` (dense biases too: they enter the bf16
    product's epilogue), the LSTM's biases and ``layer_6``'s bias in
    float32."""
    w1 = params["layer_1"].weight
    spread = w1.new_zeros((WINDOW_FRAMES, FEATURE_WIDTH, w1.shape[1]))
    spread[:, :N_INPUT] = w1.reshape(WINDOW_FRAMES, N_INPUT, -1)
    out = {
        "layer_1": Dense(spread.reshape(WINDOW_FRAMES * FEATURE_WIDTH, -1).to(dtype),
                         params["layer_1"].bias.to(dtype)),
        "layer_6": Dense(params["layer_6"].weight.to(dtype), params["layer_6"].bias.float()),
    }
    for name in ("layer_2", "layer_3", "layer_5"):
        out[name] = Dense(*(t.to(dtype) for t in params[name]))
    lstm = params["lstm"]
    out["lstm"] = lstm._replace(w_ih=lstm.w_ih.to(dtype), w_hh=lstm.w_hh.to(dtype),
                                b_ih=lstm.b_ih.float(), b_hh=lstm.b_hh.float())
    return out


def windows(feats: torch.Tensor) -> torch.Tensor:
    """(T, B, C) frames -> (T, B, 19 C): frame t's window [f(t - 9), ...,
    f(t + 9)], zeros outside [0, T) (``create_overlapping_windows``, a conv1d
    with an identity filter and SAME padding)."""
    t_max, batch, width = feats.shape
    padded = torch.nn.functional.pad(feats, (0, 0, 0, 0, N_CONTEXT, N_CONTEXT))
    return (padded.unfold(0, WINDOW_FRAMES, 1)     # (T, B, C, 19)
            .transpose(2, 3).reshape(t_max, batch, WINDOW_FRAMES * width))


def dense(x: torch.Tensor, layer: Dense) -> torch.Tensor:
    """x (T, B, in) @ weight + bias in the weight's dtype, then min(max(., 0),
    20): (T, B, out) in the weight's dtype."""
    t_max, batch, _ = x.shape
    w = layer.weight
    y = torch.addmm(layer.bias, x.reshape(t_max * batch, -1).to(w.dtype), w)
    return y.clamp_(0.0, RELU_CLIP).reshape(t_max, batch, -1)


def head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``layer_5`` (clipped) then ``layer_6`` on (T, B, H) -> (T, B, C) f32
    logits; ``layer_6`` takes operands rounded to its weight's dtype and
    accumulates in f32."""
    x = dense(x, params["layer_5"])
    w = params["layer_6"].weight
    return x.to(w.dtype).float() @ w.float() + params["layer_6"].bias


def forward(params: dict, waveforms: torch.Tensor, input_lengths: torch.Tensor,
            softmax: bool = True, rnn_impl: str = "auto"):
    """Batch forward from (N, n) int16-scale waveforms (n at least 512) and
    their (N,) sample counts -> ((N, T, C) probabilities, or logits with
    ``softmax=False``; (N,) frame counts). ``params`` is
    :func:`compute_params`'s tree; ``rnn_impl`` goes to
    :func:`..ops.rnn.lstm_layer`."""
    with annotate("model.features"):
        feats, lengths = mfcc_ops.mfcc(waveforms, input_lengths, width=FEATURE_WIDTH)
    with annotate("model.context"):
        x = windows(feats.transpose(0, 1).to(params["layer_1"].weight.dtype))
    with annotate("model.dense"):
        for name in ("layer_1", "layer_2", "layer_3"):
            x = dense(x, params[name])
    with annotate("model.rnn"):
        x = rnn_ops.lstm_layer(x, lengths, params["lstm"], impl=rnn_impl)
    with annotate("model.head"):
        x = head(params, x).transpose(0, 1)  # (N, T, C)
        if softmax:
            x = torch.softmax(x, dim=-1)
    return x, lengths
