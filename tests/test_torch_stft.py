"""The port's frame_signal, magnitude_stft, streaming_log_spectrogram and
the ``use_fft`` argument against the JAX package's ops/stft.py (CPU).

Inputs are int16-scale waveforms from numpy ``default_rng``. With
``use_fft=False`` both packages multiply float32 frames by the same float32
cos and sin bases (equal bit for bit), so only the summation order of the
products differs; with ``use_fft=True`` both take an FFT. Measured on the
CPU: magnitudes differ by at most 9.7e-7 (DFT) and 3.2e-7 (FFT) of the
frame's largest bin, so MAG_RTOL = 2e-6. In the log domain the rounding is
absolute, and log1p magnifies it at the few bins whose magnitude is near
zero. Over six seeded batches the port's matmul DFT met JAX's default with
a largest difference of 7.4e-5 to 3.1e-4 (the rFFT: 5.3e-5 to 4.5e-4) and
a 99.9th percentile of 7.4e-6 to 8.6e-6 (the rFFT: 6.7e-6 to 7.6e-6): the
two DFTs agree no better than the rFFT does, since two BLAS orders of 320
float32 products differ as much as an FFT's. So ``batched_log_spectrogram``
is held to BATCH_MAX = 4e-4, below C4's 5e-4, and every log spectrogram to
a 99.9th percentile of P999 = 2e-5. One utterance alone (no batch mean to
dilute a near-zero bin) reached 8.3e-4, so LOG_MAX = 2e-3 there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from danspeech_tpu.features import windows as jwin
from danspeech_tpu.ops import stft as jstft
from danspeech_tpu_torch.ops import stft as tstft

N_FFT, HOP = 320, 160
MAG_RTOL = 2e-6
BATCH_MAX = 4e-4
LOG_MAX = 2e-3
P999 = 2e-5


def _assert_log_close(got, ref, largest):
    d = np.abs(np.asarray(got) - np.asarray(ref))
    assert float(d.max()) <= largest, float(d.max())
    assert float(np.quantile(d, 0.999)) <= P999, float(np.quantile(d, 0.999))


def _window():
    return jwin.get_window("hamming", N_FFT).astype(np.float32)


def _wave(seed, n):
    return (np.random.default_rng(seed).normal(size=n) * 3000.0).astype(np.float32)


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("n", [16000, 4321, 481])
def test_frame_signal_matches_jax(center, n):
    y = _wave(0, n)
    ref = np.asarray(jstft.frame_signal(jnp.asarray(y), N_FFT, HOP, center))
    got = tstft.frame_signal(torch.from_numpy(y), N_FFT, HOP, center)
    assert got.shape == ref.shape == (tstft.num_frames(n, N_FFT, HOP, center), N_FFT)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_frame_signal_odd_hop_matches_jax():
    """A hop that does not divide n_fft takes JAX's gather path."""
    y = _wave(1, 3000)
    ref = np.asarray(jstft.frame_signal(jnp.asarray(y), 400, 150, True))
    got = tstft.frame_signal(torch.from_numpy(y), 400, 150, True)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("use_fft", [False, True])
@pytest.mark.parametrize("center", [True, False])
def test_magnitude_stft_matches_jax(use_fft, center):
    y, win = _wave(2, 12345), _window()
    ref = np.asarray(jstft.magnitude_stft(jnp.asarray(y), N_FFT, HOP, jnp.asarray(win),
                                          center=center, use_fft=use_fft))
    got = tstft.magnitude_stft(torch.from_numpy(y), N_FFT, HOP, torch.from_numpy(win),
                               center=center, use_fft=use_fft).numpy()
    assert got.shape == ref.shape == (N_FFT // 2 + 1,
                                      tstft.num_frames(12345, N_FFT, HOP, center))
    assert float((np.abs(got - ref) / ref.max(axis=0, keepdims=True)).max()) <= MAG_RTOL


@pytest.mark.parametrize("use_fft", [False, True])
def test_streaming_log_spectrogram_matches_jax(use_fft):
    y, win = _wave(3, 6240), _window()
    mean, std = np.float32(4.25), np.float32(1.75)
    ref = np.asarray(jstft.streaming_log_spectrogram(
        jnp.asarray(y), N_FFT, HOP, jnp.asarray(win), jnp.float32(mean), jnp.float32(std),
        use_fft=use_fft))
    got = tstft.streaming_log_spectrogram(
        torch.from_numpy(y), N_FFT, HOP, torch.from_numpy(win), torch.tensor(mean),
        torch.tensor(std), use_fft=use_fft)
    assert got.shape == ref.shape == (N_FFT // 2 + 1, 1 + (6240 - N_FFT) // HOP)
    _assert_log_close(got, ref, LOG_MAX)


@pytest.mark.parametrize("use_fft", [False, True])
def test_log_spectrogram_use_fft_matches_jax(use_fft):
    y, win = _wave(4, 16000), _window()
    ref = np.asarray(jstft.log_spectrogram(jnp.asarray(y), N_FFT, HOP, jnp.asarray(win),
                                           use_fft=use_fft))
    got = tstft.log_spectrogram(torch.from_numpy(y), N_FFT, HOP, torch.from_numpy(win),
                                use_fft=use_fft)
    assert got.shape == ref.shape
    _assert_log_close(got, ref, LOG_MAX)


@pytest.mark.parametrize(
    "lengths,n",
    [([16000, 12345, 4000, 9001], 16000), ([16000, 161, 100, 2], 16000)],
)
def test_batched_matmul_dft_matches_jax_default(lengths, n):
    """``use_fft=False`` against the JAX package's default DFT, within
    BATCH_MAX and P999 (the rFFT default is held to C4's 5e-4 in
    tests/test_torch_features.py)."""
    rng = np.random.default_rng(5)
    batch = np.zeros((len(lengths), n), np.float32)
    for i, length in enumerate(lengths):
        batch[i, :length] = rng.normal(size=length) * 3000.0
    lens, win = np.asarray(lengths, np.int32), _window()
    ref, ref_len = jstft.batched_log_spectrogram(jnp.asarray(batch), jnp.asarray(lens),
                                                 N_FFT, HOP, jnp.asarray(win))
    got, got_len = tstft.batched_log_spectrogram(
        torch.from_numpy(batch), torch.from_numpy(lens), N_FFT, HOP,
        torch.from_numpy(win), use_fft=False)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    _assert_log_close(got, ref, BATCH_MAX)


def test_default_stays_the_rfft():
    """The served spectrogram keeps the rFFT (ROADMAP C4): the default is
    ``use_fft=True`` and equals it bit for bit."""
    rng = np.random.default_rng(6)
    batch = torch.from_numpy((rng.normal(size=(2, 8000)) * 3000.0).astype(np.float32))
    lens, win = torch.tensor([8000, 5000]), torch.from_numpy(_window())
    a, _ = tstft.batched_log_spectrogram(batch, lens, N_FFT, HOP, win)
    b, _ = tstft.batched_log_spectrogram(batch, lens, N_FFT, HOP, win, use_fft=True)
    assert torch.equal(a, b)


def test_dft_bases_are_cached_per_size_dtype_and_device():
    a = tstft._dft_matrices(N_FFT, torch.float32, torch.device("cpu"))
    assert tstft._dft_matrices(N_FFT, torch.float32, torch.device("cpu")) is a
    assert a[0].shape == (N_FFT, N_FFT // 2 + 1) and a[0].dtype == torch.float32
    cos_j, sin_j = jstft._dft_matrices(N_FFT, "float32")
    np.testing.assert_array_equal(a[0].numpy(), cos_j)
    np.testing.assert_array_equal(a[1].numpy(), sin_j)
