"""Batch and streaming log-spectrogram parsers.

The port of ``danspeech_tpu/features/spectrogram.py`` (the original
danspeech ``parsers.py``): the parsers hold the audio config and window.
The batch STFT runs in :mod:`danspeech_tpu_torch.ops.stft` on the device of
the waveform it is given; the streaming parser is host numpy.
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


class InferenceSpectrogramAudioParser(AudioParser):
    """Streaming parser with a rolling sample buffer and adaptive
    normalisation (a copy of the JAX package's, host numpy):

    - chunks are STFT'd with ``center=False``; a ``hop_length``-sized sample
      tail (plus the hop remainder) carries over so frames tile the stream;
    - the normalisation blends fixed NST dataset statistics with running
      input statistics, ramping ``alpha`` by 0.1 per chunk;
    - a final chunk is dropped (returns []) when buffer + chunk hold less
      than ``n_fft`` samples; a shorter chunk that is not final is held for
      the next one.
    """

    DATASET_MEAN = 5.492418704733003
    DATASET_STD = 1.7552755216970917

    def __init__(self, audio_config: dict | None = None):
        super().__init__(audio_config)
        self.input_mean = 0.0
        self.input_std = 0.0
        self.alpha = 0.0
        self.alpha_increment = 0.1
        self.buffer = None
        self.has_buffer = False

    def parse_audio(self, part_of_recording, is_last: bool = False):
        part = np.asarray(part_of_recording, dtype=np.float32)

        if self.has_buffer:
            part = np.concatenate((self.buffer, part), axis=None)

        if len(part) < self.n_fft:
            # too short for one frame: a final chunk ends the stream, any
            # other is held (0 frames would poison the running statistics)
            if is_last:
                self.reset()
                return []
            self.buffer = part
            self.has_buffer = True
            return []

        # hold back the hop remainder so chunk boundaries tile exactly
        extra_samples = len(part) % self.hop_length
        if extra_samples != 0:
            extra_samples_array = part[-extra_samples:]
            part = part[:-extra_samples]

        self.buffer = part[-self.hop_length :]
        if extra_samples != 0:
            self.buffer = np.concatenate((self.buffer, extra_samples_array), axis=None)
        self.has_buffer = True

        n_frames = 1 + (len(part) - self.n_fft) // self.hop_length
        frames = np.lib.stride_tricks.as_strided(
            part,
            (n_frames, self.n_fft),
            (part.strides[0] * self.hop_length, part.strides[0]),
        )
        spect = np.log1p(
            np.abs(np.fft.rfft(frames * self.window_np, axis=-1)).T.astype(np.float32)
        )

        # adaptive normalisation; the running stats use the biased std
        self.alpha += self.alpha_increment
        chunk_mean = float(np.mean(spect))
        chunk_std = float(np.std(spect))
        self.input_mean = (self.input_mean + chunk_mean) / 2
        self.input_std = (self.input_std + chunk_std) / 2

        if self.alpha < 1.0:
            mean = self.input_mean * self.alpha + (1 - self.alpha) * self.DATASET_MEAN
            std = self.input_std * self.alpha + (1 - self.alpha) * self.DATASET_STD
        else:
            mean = self.input_mean
            std = self.input_std

        return (spect - mean) / std

    def reset(self):
        self.buffer = None
        self.has_buffer = False
        self.input_mean = 0.0
        self.input_std = 0.0
        self.alpha = 0.0
