"""DeepSpeech2 acoustic model as a parameter tree + plain functions.

The port of ``danspeech_tpu/models/deepspeech.py``: ``forward(params,
config, spect, lengths)`` on tensors, with the parameter tree of the JAX
package (dicts, lists and NamedTuples of tensors). Semantics of the
original DeepSpeech2: masked conv stack, bidirectional RNNs whose
directions are summed (the ``gru_bidi_fused`` kernel on CUDA) or
unidirectional RNNs followed by the lookahead convolution and hardtanh (the
``gru_scan`` kernel on CUDA), BN -> Linear head, softmax at inference. The
streaming twin of the forward pass is :mod:`.streaming`.

The forward pass is differentiable in every parameter leaf (training:
:mod:`danspeech_tpu_torch.train`). Only GRU models are ported so far; LSTM
and tanh-RNN models raise.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops import conv as conv_ops
from ..ops import rnn as rnn_ops
from ..ops.conv import BatchNormParams, ConvParams, LinearParams, LookaheadParams
from .config import CONV_SPECS, DeepSpeechConfig

Params = dict[str, Any]


def _require_gru(config: DeepSpeechConfig) -> None:
    if config.rnn_type != "gru":
        raise NotImplementedError(
            f"rnn_type={config.rnn_type!r}: only GRU models are ported so far "
            "(LSTM and tanh-RNN come with the ports of their kernels, ROADMAP "
            "queue B5-B8)"
        )


def map_params(fn: Callable[[torch.Tensor], torch.Tensor], params: Params) -> Params:
    """Apply ``fn`` to every tensor of the tree, keeping its structure."""

    def walk(node):
        if node is None:
            return None
        if isinstance(node, torch.Tensor):
            return fn(node)
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        raise TypeError(f"unexpected node in params: {type(node)}")

    return walk(params)


def params_to(params: Params, device) -> Params:
    return map_params(lambda t: t.to(device), params)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def init_params(
    config: DeepSpeechConfig, seed: int = 0, dtype=torch.float32
) -> Params:
    """Random parameters with torch-default initializers, drawn from
    ``np.random.default_rng(seed)`` in the JAX package's order, so the same
    seed gives bit-identical weights in both packages."""
    _require_gru(config)
    rng = np.random.default_rng(seed)

    def uniform(shape, bound):
        a = rng.uniform(-bound, bound, size=shape).astype(np.float32)
        return torch.from_numpy(a).to(dtype)

    def ones(n):
        return torch.ones((n,), dtype=dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype)

    convs = []
    for spec in CONV_SPECS[: config.conv_layers]:
        kf, kt = spec["kernel"]
        fan_in = spec["in"] * kf * kt
        bound = 1.0 / math.sqrt(fan_in)
        convs.append(
            ConvParams(
                weight=uniform(
                    (spec["out"], spec["in"], kf, kt),
                    math.sqrt(6.0 / fan_in) / math.sqrt(2.0),
                ),
                bias=uniform((spec["out"],), bound),
                bn_gamma=ones(spec["out"]),
                bn_beta=zeros(spec["out"]),
                bn_mean=zeros(spec["out"]),
                bn_var=ones(spec["out"]),
            )
        )

    hidden = config.rnn_hidden_size
    bound = 1.0 / math.sqrt(hidden)

    def rnn_dir(input_size):
        return rnn_ops.GRUWeights(
            w_ih=uniform((input_size, 3 * hidden), bound),
            w_hh=uniform((hidden, 3 * hidden), bound),
            b_ih=uniform((3 * hidden,), bound),
            b_hh=uniform((3 * hidden,), bound),
        )

    rnns = []
    in_size = config.rnn_input_size
    for layer in range(config.rnn_layers):
        bn = None
        if layer > 0:
            bn = BatchNormParams(
                gamma=ones(in_size), beta=zeros(in_size),
                mean=zeros(in_size), var=ones(in_size),
            )
        fwd = rnn_dir(in_size)
        bwd = rnn_dir(in_size) if config.bidirectional else None
        rnns.append({"bn": bn, "fwd": fwd, "bwd": bwd})
        in_size = hidden

    look = None
    if not config.bidirectional:
        look = LookaheadParams(
            weight=uniform((hidden, config.context), 1.0 / math.sqrt(config.context))
        )

    return {
        "conv": convs,
        "rnns": rnns,
        "lookahead": look,
        "fc_bn": BatchNormParams(
            gamma=ones(hidden), beta=zeros(hidden),
            mean=zeros(hidden), var=ones(hidden),
        ),
        "fc": LinearParams(
            weight=uniform((config.num_classes, hidden), 1.0 / math.sqrt(hidden)),
            bias=None,
        ),
    }


def num_params(params: Params) -> int:
    total = 0

    def count(t):
        nonlocal total
        total += t.numel()
        return t

    map_params(count, params)
    return total


def cast_matmul_weights(params: Params, dtype=torch.bfloat16) -> Params:
    """Cast the large matmul weights (RNN w_ih/w_hh, conv kernels, FC) to
    ``dtype``; biases and BatchNorm statistics stay float32. The casts are
    differentiable: gradients reach float32 master leaves through them."""

    def cast_rnn(w):
        if w is None:
            return None
        return w._replace(w_ih=w.w_ih.to(dtype), w_hh=w.w_hh.to(dtype))

    out: Params = dict(params)
    out["conv"] = [c._replace(weight=c.weight.to(dtype)) for c in params["conv"]]
    out["rnns"] = [
        {"bn": e["bn"], "fwd": cast_rnn(e["fwd"]), "bwd": cast_rnn(e["bwd"])}
        for e in params["rnns"]
    ]
    out["fc"] = params["fc"]._replace(weight=params["fc"].weight.to(dtype))
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def get_seq_lens(config: DeepSpeechConfig, input_lengths):
    """Output frame counts after the conv stack."""
    lengths = input_lengths
    for spec in CONV_SPECS[: config.conv_layers]:
        _, kt = spec["kernel"]
        _, st = spec["stride"]
        _, pt = spec["padding"]
        lengths = conv_ops.conv_out_length(lengths, kt, st, pt)
    return lengths


def conv_stack(
    params: Params,
    config: DeepSpeechConfig,
    x: torch.Tensor,
    out_lengths: torch.Tensor,
    folded: bool = True,
) -> torch.Tensor:
    """Masked conv stack on (N, 1, F, T) -> (N, C, F', T')."""
    for p, spec in zip(params["conv"], CONV_SPECS[: config.conv_layers]):
        x = conv_ops.conv_block(
            x, p, out_lengths, spec["stride"], spec["padding"], folded=folded
        )
    return x


def head(params: Params, x: torch.Tensor) -> torch.Tensor:
    """BN -> Linear(num_classes, no bias) on (T, B, H) -> (T, B, C) f32.
    The product takes operands rounded to the weight's dtype and
    accumulates in f32."""
    scale, shift = params["fc_bn"].scale_shift()
    x = x * scale + shift
    w = params["fc"].weight
    return x.to(w.dtype).float() @ w.float().T


def _apply_rnn_layer(entry, x, lengths, impl: str) -> torch.Tensor:
    if entry["bn"] is not None:
        scale, shift = entry["bn"].scale_shift()
        x = x * scale + shift
    out, _ = rnn_ops.gru_layer(x, lengths, entry["fwd"], entry["bwd"], impl=impl)
    return out


def forward(
    params: Params,
    config: DeepSpeechConfig,
    x: torch.Tensor,
    input_lengths: torch.Tensor,
    softmax: bool = True,
    rnn_impl: str = "auto",
    rnn_remat: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch forward: (N, 1, F, T) spectrograms -> ((N, T', C) probs, or
    logits with ``softmax=False``; (N,) output lengths). ``rnn_impl`` is
    passed to :func:`rnn_ops.gru_layer`. ``rnn_remat`` checkpoints each RNN
    layer (``torch.utils.checkpoint``): the backward pass runs the layer's
    forward again instead of keeping its residuals, so only one layer's
    output streams are alive at a time."""
    _require_gru(config)
    out_lengths = get_seq_lens(config, input_lengths)
    x = conv_stack(params, config, x, out_lengths)

    n, c, f, t = x.shape
    x = x.reshape(n, c * f, t).permute(2, 0, 1)  # (T, N, H)

    for entry in params["rnns"]:
        if rnn_remat:
            x = checkpoint(_apply_rnn_layer, entry, x, out_lengths, rnn_impl,
                           use_reentrant=False)
        else:
            x = _apply_rnn_layer(entry, x, out_lengths, rnn_impl)

    if not config.bidirectional:
        x = conv_ops.hardtanh(conv_ops.lookahead(x, params["lookahead"]))

    x = head(params, x).permute(1, 0, 2)  # (N, T, C)
    if softmax:
        x = torch.softmax(x, dim=-1)
    return x, out_lengths
