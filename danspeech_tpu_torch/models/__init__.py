"""Model package: DeepSpeech2 and Mozilla DeepSpeech (``config.family``)
configs, params, forward passes, checkpoints."""

from __future__ import annotations

from .config import DeepSpeechConfig, default_labels  # noqa: F401
from . import deepspeech, mozilla  # noqa: F401
from .deepspeech import forward, init_params, num_params  # noqa: F401


class DeepSpeechModel:
    """A loaded acoustic model: config + parameter tree (float32, CPU).

    The attribute surface the recognizer reads from the original
    ``DeepSpeech`` module (model_name, labels, audio_conf, context, ...);
    the engine casts and moves the parameters to its own device.
    """

    def __init__(self, config: DeepSpeechConfig, params):
        self.config = config
        self.params = params

    @property
    def model_name(self):
        return self.config.model_name

    @property
    def labels(self):
        return self.config.labels

    @property
    def audio_conf(self):
        return self.config.audio_conf

    @property
    def context(self):
        return self.config.context

    @property
    def rnn_hidden_size(self):
        return self.config.rnn_hidden_size

    @property
    def streaming_model(self):
        return self.config.streaming_model

    def get_param_size(self) -> int:
        return num_params(self.params)

    @classmethod
    def load_model(cls, path) -> "DeepSpeechModel":
        """Load a native ``.dsz`` checkpoint, or else a zoo ``.pth`` package
        (zip or legacy format; loading executes no code)."""
        from .checkpoint import load_checkpoint, load_reference_checkpoint

        p = str(path)
        if p.endswith(".dsz"):
            config, params = load_checkpoint(p)
        else:
            config, params = load_reference_checkpoint(p)
        return cls(config, params)

    @classmethod
    def load_model_package(cls, package: dict) -> "DeepSpeechModel":
        """A model from an already loaded package dict."""
        from .checkpoint import config_from_package, params_from_state_dict

        config = config_from_package(package)
        return cls(config, params_from_state_dict(package["state_dict"], config))

    @classmethod
    def init_random(cls, config: DeepSpeechConfig, seed: int = 0) -> "DeepSpeechModel":
        init = mozilla.init_params if config.family == mozilla.FAMILY else init_params
        return cls(config, init(config, seed=seed))

    def save(self, path: str) -> None:
        from .checkpoint import save_checkpoint

        save_checkpoint(path, self.config, self.params)


# the original package exposes the model class as ``DeepSpeech``
DeepSpeech = DeepSpeechModel
