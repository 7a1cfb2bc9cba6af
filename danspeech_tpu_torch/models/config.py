"""Typed model configuration (a copy of ``danspeech_tpu/models/config.py``)."""

from __future__ import annotations

import json
import math
import os
from dataclasses import asdict, dataclass, field

from ..errors import ConvError
from ..features.spectrogram import get_default_audio_config

_LABELS_PATH = os.path.join(os.path.dirname(__file__), "labels.json")


def default_labels() -> str:
    """The 33-char DanSpeech label set: blank '_' at 0, space at 32."""
    with open(_LABELS_PATH, "r", encoding="utf-8") as f:
        return "".join(json.load(f))


# (kernel, stride, padding) per conv layer along (freq, time); channel plan
# of the original DeepSpeech2 conv stack.
CONV_SPECS = [
    {"kernel": (41, 11), "stride": (2, 2), "padding": (20, 5), "in": 1, "out": 32},
    {"kernel": (21, 11), "stride": (2, 1), "padding": (10, 5), "in": 32, "out": 32},
    {"kernel": (21, 11), "stride": (2, 1), "padding": (10, 5), "in": 32, "out": 96},
]

SUPPORTED_RNNS = ("gru", "lstm", "rnn")
# the model families: DeepSpeech2 (models/deepspeech.py, every zoo package and
# .dsz written before the field) and Mozilla DeepSpeech (models/mozilla.py)
FAMILIES = ("ds2", "mozilla")


@dataclass
class DeepSpeechConfig:
    """Everything needed to rebuild a model graph from a checkpoint."""

    model_name: str = "deepspeech"
    rnn_type: str = "gru"
    labels: str = field(default_factory=default_labels)
    rnn_hidden_size: int = 768
    rnn_layers: int = 5
    audio_conf: dict = field(default_factory=get_default_audio_config)
    bidirectional: bool = True
    conv_layers: int = 2
    context: int = 20
    streaming_model: bool = False
    family: str = "ds2"

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"family must be one of {FAMILIES}")
        if self.family == "mozilla":
            # one graph: dense layers around one unidirectional LSTM, no convs
            self.rnn_type, self.rnn_layers, self.conv_layers = "lstm", 1, 0
            self.bidirectional = self.streaming_model = False
            return
        if self.conv_layers == 0:
            raise ConvError("0 convolutional layers configuration not supported")
        if self.conv_layers > 3:
            raise ConvError("Maximum supported convolutional layers is 3")
        if self.rnn_type not in SUPPORTED_RNNS:
            raise ValueError(f"rnn_type must be one of {SUPPORTED_RNNS}")
        if self.streaming_model and self.bidirectional:
            # the original streaming model is always unidirectional, whatever
            # its package metadata says: normalise here so the checkpoint
            # loader, init_params and forward agree
            self.bidirectional = False
        if not self.labels:
            self.labels = default_labels()
        if not self.audio_conf:
            self.audio_conf = get_default_audio_config()

    @property
    def num_classes(self) -> int:
        return len(self.labels)

    @property
    def blank_index(self) -> int:
        return self.labels.index("_")

    @property
    def n_freq(self) -> int:
        sample_rate = self.audio_conf.get("sampling_rate", 16000)
        window_size = self.audio_conf.get("window_size", 0.02)
        return int(math.floor(sample_rate * window_size / 2) + 1)  # 161

    @property
    def rnn_input_size(self) -> int:
        """Flattened conv output features feeding the first RNN layer."""
        size = self.n_freq
        for spec in CONV_SPECS[: self.conv_layers]:
            kf, _ = spec["kernel"]
            sf, _ = spec["stride"]
            pf, _ = spec["padding"]
            size = int(math.floor(size + 2 * pf - kf) / sf + 1)
        return size * CONV_SPECS[self.conv_layers - 1]["out"]

    def to_dict(self) -> dict:
        """The fields; a DeepSpeech2 config leaves ``family`` out, as the
        configs written before it (and the JAX package's) have none."""
        d = asdict(self)
        if self.family == "ds2":
            del d["family"]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "DeepSpeechConfig":
        return cls(**d)
