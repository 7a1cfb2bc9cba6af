"""A served LSTM model: deepspeech.pytorch's bidirectional DeepSpeech2 with
random weights in the layout ``nn.LSTM`` and ``nn.BatchNorm`` save, the
program's ``Recognizer`` loaded from them through its package path, and the
comparison against the LSTM reference (``reference/lstm_ref.py``).

The weights are made on the device from the seed in one draw, as
:mod:`weights` makes the GRU models': PyTorch's default initialisers for
the convolutions and the LSTM (U(-1/sqrt(H), 1/sqrt(H)) for every weight
and bias), BatchNorm affines near identity, the head multiplied by the
configuration's ``head_gain``, then every BatchNorm's running statistics
set, layer after layer, to those of its input over a seeded calibration
batch (:data:`weights.CALIBRATION`) through the reference. Unlike
:mod:`weights`, every tensor is contiguous, the recurrent ones included:
``weight_ih_l0`` (4H, I) and ``weight_hh_l0`` (4H, H), as ``nn.LSTM``
saves them.
"""

from __future__ import annotations

import math
import time

import torch

import check
import lstm_work
import mixes
import weights
from driver import Driver
from mixes import derived_seed
from reference.lstm_ref import Model as Reference
from serving import Serving, sync
from work import CONV_SPECS, rnn_layers


def layout(config: dict) -> list:
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
    gates = lstm_work.GATES * config["rnn_hidden_size"]
    suffixes = ["", "_reverse"] if config["bidirectional"] else [""]
    for k, (width, hidden, _) in enumerate(rnn_layers(config)):
        bound = 1.0 / math.sqrt(hidden)
        if k > 0:
            out += bn(f"rnns.{k}.batch_norm.module", width)
        for s in suffixes:
            out += [(f"rnns.{k}.rnn.weight_ih_l0{s}", (gates, width), bound, 0.0),
                    (f"rnns.{k}.rnn.weight_hh_l0{s}", (gates, hidden), bound, 0.0),
                    (f"rnns.{k}.rnn.bias_ih_l0{s}", (gates,), bound, 0.0),
                    (f"rnns.{k}.rnn.bias_hh_l0{s}", (gates,), bound, 0.0)]
    hidden = config["rnn_hidden_size"]
    out += bn("fc.0.module.0", hidden)
    out.append(("fc.0.module.1.weight", (len(config["labels"]), hidden),
                config["head_gain"] / math.sqrt(hidden), 0.0))
    return out


def state_dict(config: dict, seed: int, device) -> dict:
    """The float32 state dict of ``config`` drawn from ``seed`` on
    ``device``: one uniform draw, each tensor a contiguous view of it scaled
    in place. BatchNorm's ``num_batches_tracked`` is 0; its running
    statistics are set by :func:`calibrate`."""
    spec = layout(config)
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, 0))
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    sd, at = {}, 0
    for key, shape, scale, offset in spec:
        n = math.prod(shape)
        sd[key] = flat[at : at + n].view(shape).mul_(scale).add_(offset)
        at += n
        if key.endswith("running_var"):
            sd[key[: -len("running_var")] + "num_batches_tracked"] = torch.zeros(
                (), dtype=torch.int64, device=device)
    return sd


def calibrate(sd: dict, config: dict, seed: int, device) -> None:
    """Every BatchNorm's running statistics in ``sd`` set, through the LSTM
    reference, to those of its input over :data:`weights.CALIBRATION` (a
    stream of its own of ``seed``)."""
    Reference(sd, config).calibrate(
        mixes.pool(weights.CALIBRATION, derived_seed(seed, 4), device)[0])


class LSTMServing(Serving):
    """:class:`serving.Serving` for an LSTM configuration: its own weights,
    calibration, operation count and reference; the pool, the sample and
    the comparison's rule are the GRU drivers'."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from danspeech_tpu_torch import Recognizer
        from danspeech_tpu_torch.models import DeepSpeechModel

        Driver.__init__(self, config, mix, seed, device)
        self.sd = state_dict(config, seed, device)
        sync(device)
        t_ref = time.perf_counter()
        calibrate(self.sd, config, seed, device)
        sync(device)
        self.reference_s = time.perf_counter() - t_ref
        model = DeepSpeechModel.load_model_package(weights.package(config, self.sd))
        self.rec = Recognizer(model=model, device=device, compute_dtype=config["compute_dtype"])
        self.pool = mixes.pool(mix, seed, device)

    def flops(self, entry) -> float:
        return lstm_work.model_flops_per_frame(self.config) * self.frames(entry)

    def gaps(self, requests: list, outputs: list, control: bool = False) -> dict:
        """As :meth:`serving.Serving.gaps`, against the LSTM reference."""
        if not requests:
            return {"text": []}
        keys = sorted({key for _, key in requests})
        waves = [self.pool[c][r] for c, r in keys]

        def logits(**kw):
            return dict(zip(keys, (x.cpu().numpy() for x in
                                   Reference(self.sd, self.config, **kw).logits(waves))))

        exact = logits()
        labels = self.config["labels"]
        blank = labels.index("_")
        out = {"text": [check.text_gap(exact[key], outputs[n][key[1]], labels, blank)
                        for n, key in requests]}
        if control:
            low = logits(control=True)
            out["control_text"] = [check.text_gap(exact[k], check.greedy_text(low[k], labels,
                                                                             blank),
                                                  labels, blank) for k in keys]
            out["control_frame"] = [check.frame_gap(exact[k], low[k].argmax(1)) for k in keys]
        return out
