"""The MFCC front end of Mozilla DeepSpeech on tensors (any device).

DeepSpeech 0.9.3 (``training/deepspeech_training/util/feeding.py``
``audio_to_features``) feeds its model TensorFlow's ``audio_spectrogram``
(``magnitude_squared=True``) and ``mfcc`` ops, whose C++ kernels
(``spectrogram.cc``, ``mfcc_mel_filterbank.cc``, ``mfcc_dct.cc``) this
module follows, over samples scaled to [-1, 1) (int16 / 32768):

- the power spectrogram: a periodic Hann window of 512 samples (32 ms at
  16 kHz), hop 320 (20 ms), a 512-point DFT, |X|^2 in 257 bins, over whole
  windows only: ``1 + (n - 512) // 320`` frames of n samples, none below
  512 (no centring, no padding);
- the mel filterbank: 40 triangular channels between 20 Hz and 8 kHz on
  mel(f) = 1127 ln(1 + f / 700), applied to the square root of each bin
  (the magnitude), bins 2 .. 256 (DC and the first bin excluded, as HTK);
- log(max(v, 1e-12)), then the DCT-II cos(pi i (j + 1/2) / 40) sqrt(2 / 40)
  and its first 26 coefficients.

Everything runs in float32 on the waveforms' device, products without TF32
(:func:`precision.full_float32`); the window, the filterbank and the DCT
matrix are computed in float64 once and kept per device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .precision import full_float32

SAMPLE_RATE = 16000
WINDOW = 512         # feature_win_len 32 ms
HOP = 320            # feature_win_step 20 ms
BINS = WINDOW // 2 + 1
CHANNELS = 40        # TF mfcc's filterbank_channel_count
LOWER_HZ = 20.0      # lower_frequency_limit
UPPER_HZ = 8000.0    # upper_frequency_limit: the sample rate / 2
COEFFICIENTS = 26    # dct_coefficient_count: DeepSpeech's n_input
FLOOR = 1e-12        # kFilterbankFloor
PCM_SCALE = 1.0 / 32768.0  # decode_wav's int16 -> float


def num_frames(n_samples):
    """Frames of ``n_samples`` (an int or an integer tensor): whole windows
    only, 0 below one window."""
    if isinstance(n_samples, torch.Tensor):
        return torch.clamp((n_samples.long() - WINDOW) // HOP + 1, min=0)
    return max(0, (int(n_samples) - WINDOW) // HOP + 1)


def mel(freq):
    return 1127.0 * np.log1p(np.asarray(freq, dtype=np.float64) / 700.0)


def periodic_hann(n: int = WINDOW) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def filterbank(bins: int = BINS, sample_rate: float = SAMPLE_RATE, channels: int = CHANNELS,
               lower: float = LOWER_HZ, upper: float = UPPER_HZ) -> np.ndarray:
    """(bins, channels) float64 weights: channel c sums bin i's magnitude
    times [i, c]. ``channels + 1`` mel centres evenly spaced above mel(lower);
    a bin between centres c and c + 1 gives channel c the share
    (centre[c+1] - mel(f)) / (centre[c+1] - centre[c]) and channel c + 1 the
    rest; below the first centre it gives channel 0 the share of its rise
    from mel(lower)."""
    mel_low, mel_high = mel(lower), mel(upper)
    centres = mel_low + (mel_high - mel_low) / (channels + 1) * np.arange(1, channels + 2)
    hz_per_bin = 0.5 * sample_rate / (bins - 1)
    first = int(1.5 + lower / hz_per_bin)
    last = int(upper / hz_per_bin)
    out = np.zeros((bins, channels))
    for i in range(first, last + 1):
        m = mel(i * hz_per_bin)
        # the channel whose right slope holds the bin: the last centre below it
        c = int(np.searchsorted(centres[:channels], m, side="left")) - 1
        if c >= 0:
            w = (centres[c + 1] - m) / (centres[c + 1] - centres[c])
            out[i, c] += w
        else:
            w = (centres[0] - m) / (centres[0] - mel_low)
        if c + 1 < channels:
            out[i, c + 1] += 1.0 - w
    return out


def dct_matrix(channels: int = CHANNELS, coefficients: int = COEFFICIENTS,
               width: int | None = None) -> np.ndarray:
    """(channels, width) float64: column i is sqrt(2 / channels) cos(pi i
    (j + 1/2) / channels) for i < ``coefficients``, zeros beyond (a width
    above 26 pads every frame with zero coefficients)."""
    width = coefficients if width is None else width
    i = np.arange(coefficients)[None, :]
    j = np.arange(channels)[:, None]
    out = np.zeros((channels, width))
    out[:, :coefficients] = np.sqrt(2.0 / channels) * np.cos(np.pi * i * (j + 0.5) / channels)
    return out


@functools.lru_cache(maxsize=8)
def _constants(device: torch.device, width: int):
    """The window, the filterbank and the DCT matrix in float32 on
    ``device``."""
    return tuple(torch.from_numpy(a).to(device=device, dtype=torch.float32)
                 for a in (periodic_hann(), filterbank(), dct_matrix(width=width)))


def power_spectrogram(samples: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """(rows, n) float32 samples in [-1, 1) -> (rows, frames, 257) |DFT|^2
    of the windowed whole frames."""
    frames = samples.unfold(-1, WINDOW, HOP) * window
    spec = torch.fft.rfft(frames, dim=-1)
    return spec.real.square() + spec.imag.square()


def mfcc(waveforms: torch.Tensor, lengths: torch.Tensor, width: int = COEFFICIENTS):
    """(rows, n) int16-scale waveforms (any real dtype) and (rows,) sample
    counts -> ((rows, frames, width) float32 coefficients, (rows,) frame
    counts). Frames at or past a row's count are exact zeros (a context
    window reads zeros past the utterance); ``width`` above 26 appends zero
    coefficients. ``n`` must be at least one window."""
    dev = waveforms.device
    window, bank, dct = _constants(dev, width)
    frame_lens = num_frames(lengths.to(dev))
    power = power_spectrogram(waveforms.float() * PCM_SCALE, window)
    with full_float32(dev):
        channels = torch.matmul(power.sqrt_(), bank)
        coeffs = torch.matmul(channels.clamp_(min=FLOOR).log_(), dct)
    valid = torch.arange(coeffs.shape[1], device=dev)[None, :] < frame_lens[:, None]
    return coeffs.mul_(valid[..., None]), frame_lens
