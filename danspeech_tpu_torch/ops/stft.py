"""STFT log-magnitude spectrograms on tensors (any device).

The port of ``danspeech_tpu/ops/stft.py``. Numerics follow ``librosa.stft``
with a symmetric scipy window, ``center=True`` reflect padding, ``log1p``
and per-utterance mean/std normalisation with the unbiased (ddof=1) std,
which is what the original danspeech parsers compute.

The DFT is ``torch.fft.rfft`` (``use_fft=True``) or the JAX package's
matmul DFT (``use_fft=False``): two float32 products of the windowed frames
with cached cos and sin bases, run in full float32 (never TF32) on CUDA.
``log_spectrogram`` and ``batched_log_spectrogram``, which the served and
trained paths call, default to the rFFT (ROADMAP C4); ``frame_signal``,
``magnitude_stft`` and ``streaming_log_spectrogram`` keep the JAX
signatures and defaults.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch


def num_frames(n_samples: int, n_fft: int, hop: int, center: bool) -> int:
    """Frame count matching librosa for the given padding mode."""
    if center:
        return 1 + n_samples // hop
    return 1 + (n_samples - n_fft) // hop


@functools.lru_cache(maxsize=8)
def _dft_matrices(n_fft: int, dtype: torch.dtype, device: torch.device):
    """Real and imaginary DFT bases (n_fft, n_fft//2+1), cached per size,
    dtype and device; computed in float64 and rounded once, as the JAX
    package's numpy bases are."""
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    ang = -2.0 * np.pi * np.outer(n, k) / n_fft
    return (torch.from_numpy(np.cos(ang)).to(device=device, dtype=dtype),
            torch.from_numpy(np.sin(ang)).to(device=device, dtype=dtype))


@contextlib.contextmanager
def _full_float32(device: torch.device):
    """Float32 products in full float32 on CUDA, whatever the process's
    ``torch.set_float32_matmul_precision`` says (TF32 keeps 10 mantissa bits
    and would move near-zero bins by far more than C4's bound)."""
    if device.type != "cuda":
        yield
        return
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def _magnitude(frames: torch.Tensor, use_fft: bool) -> torch.Tensor:
    """(..., T, n_fft) windowed frames -> (..., T, F) |DFT| in float32."""
    frames = frames.float()
    if use_fft:
        return torch.fft.rfft(frames, dim=-1).abs()
    cos_m, sin_m = _dft_matrices(frames.shape[-1], frames.dtype, frames.device)
    with _full_float32(frames.device):
        re = torch.matmul(frames, cos_m)
        im = torch.matmul(frames, sin_m)
    return torch.sqrt(re * re + im * im)


def _reflect(y: torch.Tensor, half: int) -> torch.Tensor:
    """numpy's ``pad(y, half, mode="reflect")`` of a 1-D tensor, any dtype."""
    return torch.cat([y[1 : half + 1].flip(0), y, y[-half - 1 : -1].flip(0)])


def frame_signal(y: torch.Tensor, n_fft: int, hop: int, center: bool) -> torch.Tensor:
    """Slice a 1-D signal into overlapping frames, shape (T, n_fft).

    ``center=True`` reflect-pads by n_fft//2 on both sides first (the batch
    parser's librosa default); ``center=False`` is the streaming variant."""
    if center:
        y = _reflect(y, n_fft // 2)
    return y.unfold(0, n_fft, hop)


def magnitude_stft(
    y: torch.Tensor,
    n_fft: int,
    hop: int,
    window: torch.Tensor,
    center: bool = True,
    use_fft: bool = False,
) -> torch.Tensor:
    """|STFT| of a 1-D signal -> (n_fft//2+1, T), librosa layout, float32.

    ``use_fft=False`` is the matmul DFT, ``True`` the rFFT."""
    frames = frame_signal(y, n_fft, hop, center).float()
    return _magnitude(frames * window.to(frames), use_fft).transpose(-1, -2)


def log_spectrogram(
    y: torch.Tensor,
    n_fft: int,
    hop: int,
    window: torch.Tensor,
    center: bool = True,
    normalize: bool = True,
    use_fft: bool = True,
) -> torch.Tensor:
    """(n,) waveform -> (F, T) log1p magnitude spectrogram, normalised by
    the utterance's mean and unbiased std."""
    spect = torch.log1p(magnitude_stft(y.float(), n_fft, hop, window, center, use_fft))
    if normalize:
        spect = (spect - spect.mean()) / spect.std(correction=1)
    return spect


def streaming_log_spectrogram(
    y: torch.Tensor,
    n_fft: int,
    hop: int,
    window: torch.Tensor,
    mean: torch.Tensor,
    std: torch.Tensor,
    use_fft: bool = False,
) -> torch.Tensor:
    """The chunked path's spectrogram: ``center=False``, normalised by the
    caller's adaptive mean and std (the streaming featurizer's state,
    ``features/spectrogram.py``)."""
    spect = torch.log1p(magnitude_stft(y.float(), n_fft, hop, window, center=False,
                                       use_fft=use_fft))
    return (spect - mean) / std


def batched_log_spectrogram(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    n_fft: int,
    hop: int,
    window: torch.Tensor,
    normalize: bool = True,
    use_fft: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Padded waveforms (B, n) -> ((B, F, T) spectrograms, frame_lengths).

    Each row is reflected at its own length, as if it were transcribed
    alone; normalisation statistics cover only the row's valid frames, and
    padding frames come out as exact zeros. ``frame_lengths = 1 + len // hop``.
    """
    batch = batch.float()
    rows, n = batch.shape
    half = n_fft // 2
    dev = batch.device
    lengths = lengths.to(dev).long()
    t = num_frames(n, n_fft, hop, center=True)

    padded = torch.nn.functional.pad(batch, (half, half))
    # left edge: rows are valid from 0, so plain reflection
    padded[:, :half] = batch[:, 1 : half + 1].flip(-1)
    # right edge: y_pad[half + len + k] = y[len - 2 - k] for k < half. The
    # source window start is clamped to [0, n - half] as the reference's
    # lax.dynamic_slice clamps it (rows shorter than half + 1 samples read
    # y[0:half] reversed).
    k = torch.arange(half, device=dev)
    start = (lengths - half - 1).clamp(min=0).clamp(max=n - half)
    tail = batch.gather(1, start[:, None] + k[None, :]).flip(-1)
    padded.scatter_(1, half + lengths[:, None] + k[None, :], tail)

    frames = padded.unfold(1, n_fft, hop) * window.to(batch)
    spect = torch.log1p(_magnitude(frames, use_fft)).transpose(-1, -2)
    frame_lengths = 1 + lengths // hop
    if normalize:
        mask = (torch.arange(t, device=dev)[None, :] < frame_lengths[:, None])
        mask3 = mask[:, None, :].float()
        count = (frame_lengths.float() * spect.shape[1]).clamp(min=1.0)
        mean = (spect * mask3).sum(dim=(1, 2)) / count
        var = ((spect - mean[:, None, None]).square() * mask3).sum(
            dim=(1, 2)
        ) / (count - 1.0).clamp(min=1.0)
        std = var.sqrt()
        # an all-constant row (std == 0) divides by 1 and stays finite
        std = torch.where(std == 0.0, torch.ones_like(std), std)
        spect = (spect - mean[:, None, None]) / std[:, None, None]
        spect = spect * mask3  # padding frames exactly zero
    return spect, frame_lengths.to(torch.int32)
