"""Spectrogram features of the PyTorch port against the JAX package (CPU).

Inputs are int16-scale waveforms from numpy ``default_rng``. The port
takes torch's rFFT where the JAX package multiplies by a DFT matrix in
float32, whose rounding error is absolute (proportional to the frame's
energy): at the few bins whose magnitude is near zero, log1p turns it into
differences up to ~3e-4 in normalised units. So ATOL = 5e-4 over all
elements, and at most one element in a thousand may differ by more than
TIGHT = 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from danspeech_tpu.features import windows as jwin
from danspeech_tpu.features.spectrogram import SpectrogramAudioParser as JParser
from danspeech_tpu.ops import stft as jstft
from danspeech_tpu_torch.features import windows as twin
from danspeech_tpu_torch.features.spectrogram import (
    SpectrogramAudioParser as TParser,
)
from danspeech_tpu_torch.ops import stft as tstft

ATOL = 5e-4
TIGHT = 1e-5
N_FFT, HOP = 320, 160


def _window():
    return jwin.get_window("hamming", N_FFT).astype(np.float32)


def _batch(seed, lengths, n):
    rng = np.random.default_rng(seed)
    batch = np.zeros((len(lengths), n), np.float32)
    for i, length in enumerate(lengths):
        batch[i, :length] = rng.normal(size=length) * 3000.0
    return batch, np.asarray(lengths, np.int32)


@pytest.mark.parametrize(
    "lengths,n",
    [
        ([16000, 12345, 4000, 9001], 16000),
        ([32000, 32000], 32000),
        # rows shorter than n_fft/2 + 1 samples: the clamped reflection
        ([16000, 161, 100, 2], 16000),
    ],
)
def test_batched_log_spectrogram_matches_jax(lengths, n):
    batch, lens = _batch(0, lengths, n)
    win = _window()
    ref, ref_len = jstft.batched_log_spectrogram(
        jnp.asarray(batch), jnp.asarray(lens), N_FFT, HOP, jnp.asarray(win)
    )
    got, got_len = tstft.batched_log_spectrogram(
        torch.from_numpy(batch), torch.from_numpy(lens), N_FFT, HOP,
        torch.from_numpy(win),
    )
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert np.mean(np.abs(got.numpy() - np.asarray(ref)) > TIGHT) < 1e-3
    # padding frames are exact zeros
    t = got.shape[-1]
    for row, fl in enumerate(got_len.tolist()):
        if fl < t:
            assert float(got[row, :, fl:].abs().max()) == 0.0


def test_batched_rows_match_single_utterance():
    """A padded row equals its utterance transcribed alone."""
    batch, lens = _batch(1, [16000, 9600, 4800], 16000)
    win = torch.from_numpy(_window())
    got, got_len = tstft.batched_log_spectrogram(
        torch.from_numpy(batch), torch.from_numpy(lens), N_FFT, HOP, win
    )
    for row, length in enumerate(lens.tolist()):
        alone = tstft.log_spectrogram(
            torch.from_numpy(batch[row, :length]), N_FFT, HOP, win
        )
        fl = int(got_len[row])
        np.testing.assert_allclose(
            got[row, :, :fl].numpy(), alone.numpy(), atol=ATOL, rtol=0
        )


@pytest.mark.parametrize("center", [True, False])
def test_log_spectrogram_matches_jax(center):
    rng = np.random.default_rng(2)
    y = (rng.normal(size=12000) * 2000.0).astype(np.float32)
    win = _window()
    ref = jstft.log_spectrogram(jnp.asarray(y), N_FFT, HOP, jnp.asarray(win), center=center)
    got = tstft.log_spectrogram(torch.from_numpy(y), N_FFT, HOP,
                                torch.from_numpy(win), center=center)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_parser_matches_jax():
    rng = np.random.default_rng(3)
    y = rng.normal(size=8000) * 1000.0
    ref = JParser().parse_audio(y)
    got = TParser().parse_audio(y)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["hamming", "hann", "blackman", "bartlett"])
def test_windows_equal(name):
    np.testing.assert_array_equal(twin.get_window(name, 320), jwin.get_window(name, 320))
