"""A served Mozilla DeepSpeech 0.9.3: random weights in the release's
TensorFlow variable layout, the program's ``Recognizer`` loaded from them
through its package path, and the comparison against the Mozilla reference
(``reference/mozilla_ref.py``).

The weights are made on the device from the seed in one draw, as the
release initialises them: every kernel Glorot-uniform (U(-a, a), a =
sqrt(6 / (fan_in + fan_out)); the dense layers' VarianceScaling(fan_avg,
uniform) and the LSTM kernel's default), every bias zero. The LSTM's
``kernel`` is one (2H, 4H) matrix, rows [x; h], gate columns i, c~, f, o, as
TensorFlow saves it; ``layer_6``'s weights are multiplied by the
configuration's ``head_gain``. The frames and the operations of a call are
counted from the MFCC's frames (``mozilla_work.py``).
"""

from __future__ import annotations

import math

import torch

import check
import mixes
import mozilla_work
from driver import Driver
from mixes import derived_seed
from reference.mozilla_ref import LSTM_SCOPE
from reference.mozilla_ref import Model as Reference
from serving import Serving, sync

PACKAGE_KEYS = ("model_name", "family", "rnn_hidden_size", "labels", "audio_conf")


def layout(config: dict) -> list:
    """(key, shape, scale) of every tensor: the value is scale * U(-1, 1),
    zeros where the scale is 0."""
    out = []
    for (fan_in, fan_out), name in zip(mozilla_work.dense_widths(config),
                                       ("layer_1", "layer_2", "layer_3", "layer_5", "layer_6")):
        gain = config["head_gain"] if name == "layer_6" else 1.0
        out += [(f"{name}/weights", (fan_in, fan_out),
                 gain * math.sqrt(6.0 / (fan_in + fan_out))), (f"{name}/bias", (fan_out,), 0.0)]
    h = config["rnn_hidden_size"]
    gates = mozilla_work.GATES * h
    out += [(f"{LSTM_SCOPE}/kernel", (2 * h, gates), math.sqrt(6.0 / (2 * h + gates))),
            (f"{LSTM_SCOPE}/bias", (gates,), 0.0)]
    return out


def state_dict(config: dict, seed: int, device) -> dict:
    """The float32 state dict of ``config`` drawn from ``seed`` on ``device``:
    one uniform draw for the kernels, each a contiguous view of it scaled in
    place; zero biases."""
    spec = layout(config)
    total = sum(math.prod(shape) for _, shape, scale in spec if scale)
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, 0))
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    sd, at = {}, 0
    for key, shape, scale in spec:
        if not scale:
            sd[key] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        sd[key] = flat[at : at + n].view(shape).mul_(scale)
        at += n
    return sd


def package(config: dict, sd: dict) -> dict:
    """The package ``DeepSpeechModel.load_model_package`` reads: the
    hyperparameters of a ``"mozilla"`` config beside the state dict."""
    return {**{k: config[k] for k in PACKAGE_KEYS}, "state_dict": sd}


class MozillaServing(Serving):
    """:class:`serving.Serving` for Mozilla DeepSpeech: its own weights (no
    BatchNorm to calibrate), frames, operations and reference; the pool, the
    sample and the comparison's rule are the other drivers'."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from danspeech_tpu_torch import Recognizer
        from danspeech_tpu_torch.models import DeepSpeechModel

        Driver.__init__(self, config, mix, seed, device)
        self.sd = state_dict(config, seed, device)
        sync(device)
        model = DeepSpeechModel.load_model_package(package(config, self.sd))
        self.rec = Recognizer(model=model, device=device, compute_dtype=config["compute_dtype"])
        self.pool = mixes.pool(mix, seed, device)

    def frames(self, entry) -> int:
        return sum(mozilla_work.utterance_frames(len(w)) for w in entry)

    def flops(self, entry) -> float:
        return mozilla_work.model_flops_per_frame(self.config) * self.frames(entry)

    def gaps(self, requests: list, outputs: list, control: bool = False) -> dict:
        """As :meth:`serving.Serving.gaps`, against the Mozilla reference,
        whose blank is the last label."""
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
