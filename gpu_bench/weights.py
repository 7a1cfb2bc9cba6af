"""Random weights in the published ``.pth`` state-dict layout, made on the
device from the seed in one draw.

The layout is the one ``DeepSpeech.load_model`` reads (``conv.seq_module``,
``rnns.k.rnn`` with ``_reverse`` for the second direction,
``rnns.k.batch_norm.module``, ``lookahead.0.conv``, ``fc.0.module``). The
scales are PyTorch's default initialisers, BatchNorm affines are drawn near
identity, and every BatchNorm's running statistics are then set, layer
after layer, to those of its input over a seeded calibration batch, as
training leaves them: each layer sees normalised inputs, and the greedy
path changes from frame to frame (with statistics near identity,
GPUStreamingRNN's head input is 0.01 +- 0.005 and its path one label). The
head is multiplied by the configuration's ``head_gain``, so the softmax is
sharp and a wrong recurrence moves the greedy path.

The recurrent weights (``weight_ih_l0``, ``weight_hh_l0``, (3H, I)) are
transposed views of (I, 3H) storage, as the port's own exporter
(``state_dict_from_params``) writes them: the port's loader keeps a
(3H, I) tensor's strides, so a contiguous one, as ``nn.GRU`` saves it,
reaches the CUDA kernels as a non-contiguous operand, which they refuse.
"""

from __future__ import annotations

import math

import torch

import mixes
import work
from mixes import derived_seed
from reference.deepspeech_ref import Model as Reference
from work import CONV_SPECS

# the calibration batch: eight utterances of 2-4 s in the traffic's bursts
CALIBRATION = {"calls": 1, "rows_per_call": 8, "min_s": 2.0, "max_s": 4.0,
               "sample_rate": 16000, "amplitude": 3000.0, "burst_s": [0.05, 0.4],
               "burst_db": [-40.0, 0.0]}


def _layout(config: dict) -> list:
    """(key, shape, scale, offset) of every floating tensor: the value is
    offset + scale * U(-1, 1)."""
    near_one, near_zero = (0.2, 1.0), (0.1, 0.0)

    def bn(key, n):
        return [(f"{key}.weight", (n,), *near_one), (f"{key}.bias", (n,), *near_zero),
                (f"{key}.running_mean", (n,), *near_zero),
                (f"{key}.running_var", (n,), *near_one)]

    out = []
    for i, ((kf, kt), _, _, c_in, c_out) in enumerate(CONV_SPECS[: config["conv_layers"]]):
        fan_in = c_in * kf * kt
        out += [(f"conv.seq_module.{3 * i}.weight", (c_out, c_in, kf, kt),
                 math.sqrt(3.0 / fan_in), 0.0),
                (f"conv.seq_module.{3 * i}.bias", (c_out,), 1.0 / math.sqrt(fan_in), 0.0)]
        out += bn(f"conv.seq_module.{3 * i + 1}", c_out)
    hidden = config["rnn_hidden_size"]
    bound = 1.0 / math.sqrt(hidden)
    width = work.rnn_layers(config)[0][0]
    suffixes = ["", "_reverse"] if config["bidirectional"] else [""]
    for k in range(config["rnn_layers"]):
        if k > 0:
            out += bn(f"rnns.{k}.batch_norm.module", width)
        for s in suffixes:
            out += [(f"rnns.{k}.rnn.weight_ih_l0{s}", (3 * hidden, width), bound, 0.0),
                    (f"rnns.{k}.rnn.weight_hh_l0{s}", (3 * hidden, hidden), bound, 0.0),
                    (f"rnns.{k}.rnn.bias_ih_l0{s}", (3 * hidden,), bound, 0.0),
                    (f"rnns.{k}.rnn.bias_hh_l0{s}", (3 * hidden,), bound, 0.0)]
        width = hidden
    if not config["bidirectional"]:
        context = config["context"]
        out.append(("lookahead.0.conv.weight", (hidden, 1, context),
                    1.0 / math.sqrt(context), 0.0))
    out += bn("fc.0.module.0", hidden)
    out.append(("fc.0.module.1.weight", (len(config["labels"]), hidden),
                config["head_gain"] / math.sqrt(hidden), 0.0))
    return out


def state_dict(config: dict, seed: int, device) -> dict:
    """The float32 state dict of ``config`` drawn from ``seed`` on ``device``:
    one uniform draw, each tensor a view of it scaled in place.
    BatchNorm's ``num_batches_tracked`` is 0, as in a package; its running
    statistics are set by :func:`calibrate`."""
    layout = _layout(config)
    total = sum(math.prod(shape) for _, shape, _, _ in layout)
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, 0))
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    sd, at = {}, 0
    for key, shape, scale, offset in layout:
        n = math.prod(shape)
        part = flat[at : at + n]
        if ".rnn.weight_" in key:
            sd[key] = part.view(shape[::-1]).mul_(scale).add_(offset).T
        else:
            sd[key] = part.view(shape).mul_(scale).add_(offset)
        at += n
        if key.endswith("running_var"):
            sd[key[: -len("running_var")] + "num_batches_tracked"] = torch.zeros(
                (), dtype=torch.int64, device=device)
    return sd


def calibrate(sd: dict, config: dict, seed: int, device) -> None:
    """Every BatchNorm's running statistics in ``sd`` set, through the
    reference, to those of its input over :data:`CALIBRATION` (a stream of
    its own of ``seed``)."""
    Reference(sd, config).calibrate(mixes.pool(CALIBRATION, derived_seed(seed, 4), device)[0])


def package(config: dict, sd: dict) -> dict:
    """A ``.pth`` package: the hyperparameters ``DeepSpeech.load_model``
    reads beside the state dict."""
    keys = ("model_name", "rnn_hidden_size", "rnn_layers", "labels", "audio_conf",
            "rnn_type", "bidirectional", "conv_layers", "context", "streaming_model")
    return {**{k: config[k] for k in keys}, "state_dict": sd}
