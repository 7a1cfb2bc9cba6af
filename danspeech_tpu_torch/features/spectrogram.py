"""Batch log-spectrogram parser.

The port of the batch part of ``danspeech_tpu/features/spectrogram.py``
(the original danspeech ``parsers.py``): the parser holds the audio config
and window; the STFT runs in :mod:`danspeech_tpu_torch.ops.stft` on the
device of the waveform it is given.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import stft as stft_ops
from .windows import get_window


def get_default_audio_config() -> dict:
    """The original danspeech defaults (``deepspeech/utils.py``)."""
    return {
        "normalize": True,
        "sampling_rate": 16000,
        "window": "hamming",
        "window_stride": 0.01,
        "window_size": 0.02,
    }


class AudioParser:
    """Shared config handling."""

    def __init__(self, audio_config: dict | None = None):
        self.audio_config = dict(audio_config or {})
        self.normalize = self.audio_config.get("normalize", True)
        self.sampling_rate = self.audio_config.get("sampling_rate", 16000)
        self.window_name = self.audio_config.get("window", "hamming")
        self.window_stride = self.audio_config.get("window_stride", 0.01)
        self.window_size = self.audio_config.get("window_size", 0.02)

        self.n_fft = int(self.sampling_rate * self.window_size)
        self.hop_length = int(self.sampling_rate * self.window_stride)
        self.window_np = get_window(self.window_name, self.n_fft).astype(
            np.float32
        )
        self.window = torch.from_numpy(self.window_np)

    def parse_audio(self, recording):
        raise NotImplementedError


class SpectrogramAudioParser(AudioParser):
    """One-shot utterance parser: (161, T) float32 spectrogram with
    center-padded |STFT|, log1p and per-utterance mean/std (unbiased)
    normalisation."""

    def parse_audio(self, recording) -> torch.Tensor:
        y = torch.as_tensor(np.asarray(recording), dtype=torch.float32)
        return stft_ops.log_spectrogram(
            y,
            self.n_fft,
            self.hop_length,
            self.window,
            center=True,
            normalize=self.normalize,
        )
