"""STFT log-magnitude spectrograms on tensors (any device).

The port of ``danspeech_tpu/ops/stft.py``. Numerics follow ``librosa.stft``
with a symmetric scipy window, ``center=True`` reflect padding, ``log1p``
and per-utterance mean/std normalisation with the unbiased (ddof=1) std,
which is what the original danspeech parsers compute. The DFT is
``torch.fft.rfft``.
"""

from __future__ import annotations

import torch


def num_frames(n_samples: int, n_fft: int, hop: int, center: bool) -> int:
    """Frame count matching librosa for the given padding mode."""
    if center:
        return 1 + n_samples // hop
    return 1 + (n_samples - n_fft) // hop


def _log_magnitude(frames: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """(..., T, n_fft) frames -> (..., F, T) log1p |rFFT| in float32."""
    spec = torch.fft.rfft(frames * window, dim=-1).abs()
    return torch.log1p(spec).transpose(-1, -2)


def log_spectrogram(
    y: torch.Tensor,
    n_fft: int,
    hop: int,
    window: torch.Tensor,
    center: bool = True,
    normalize: bool = True,
) -> torch.Tensor:
    """(n,) waveform -> (F, T) log1p magnitude spectrogram, normalised by
    the utterance's mean and unbiased std."""
    y = y.float()
    if center:
        y = torch.nn.functional.pad(y[None, None], (n_fft // 2, n_fft // 2),
                                    mode="reflect")[0, 0]
    spect = _log_magnitude(y.unfold(0, n_fft, hop), window.to(y))
    if normalize:
        spect = (spect - spect.mean()) / spect.std(correction=1)
    return spect


def batched_log_spectrogram(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    n_fft: int,
    hop: int,
    window: torch.Tensor,
    normalize: bool = True,
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

    spect = _log_magnitude(padded.unfold(1, n_fft, hop), window.to(batch))
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
