"""SpecAugment for training (Park et al. 2019), batched, on any device.

The port of ``danspeech_tpu/train/augment.py``. Masks are drawn per batch row
from an explicit ``torch.Generator``; the same generator state gives the
same masks. The draws cannot equal the JAX package's for the same seed (its
PRNG is another), so the two are compared by the masks' properties.
"""

from __future__ import annotations

import torch


def _randint(generator: torch.Generator, high: torch.Tensor) -> torch.Tensor:
    """Integers uniform over [0, high) per element of ``high`` (int64, >= 1),
    drawn on the generator's device."""
    u = torch.rand(high.shape, generator=generator, device=generator.device)
    high = high.to(generator.device)
    return torch.minimum((u * high).long(), high - 1)


def spec_augment(
    generator: torch.Generator,
    spect: torch.Tensor,  # (B, F, T) log-spectrograms
    frame_lengths: torch.Tensor,  # (B,) valid frames per row
    n_freq_masks: int = 2,
    freq_mask_width: int = 27,
    n_time_masks: int = 2,
    time_mask_ratio: float = 0.05,
    mask_value: float = 0.0,
) -> torch.Tensor:
    """Apply SpecAugment frequency and time masks.

    Frequency masks: ``n_freq_masks`` bands of width U{0..freq_mask_width},
    placed uniformly over [0, F - width]. Time masks: ``n_time_masks`` spans
    of width U{0..int(ratio * row_length)}, placed inside each row's valid
    frames (padding is never masked into looking like data, and masks never
    exceed the valid region).
    """
    b, f, t = spect.shape
    dev = spect.device
    lengths = frame_lengths.to("cpu", torch.int64)
    ones = torch.ones((b,), dtype=torch.int64)

    masked = torch.zeros((b, f, t), dtype=torch.bool, device=dev)
    f_idx = torch.arange(f, device=dev)[None, :]
    for _ in range(n_freq_masks):
        width = _randint(generator, ones * (freq_mask_width + 1)).cpu()
        start = _randint(generator, (f - width).clamp(min=0) + 1).cpu()
        lo, hi = start.to(dev)[:, None], (start + width).to(dev)[:, None]
        masked |= ((f_idx >= lo) & (f_idx < hi))[:, :, None]

    # float32 product truncated toward zero, as the JAX package computes it
    max_w = (lengths.to(torch.float32) * time_mask_ratio).to(torch.int64).clamp(min=0)
    t_idx = torch.arange(t, device=dev)[None, :]
    valid = t_idx < lengths.to(dev)[:, None]
    for _ in range(n_time_masks):
        width = _randint(generator, max_w + 1).cpu()
        start = _randint(generator, (lengths - width).clamp(min=0) + 1).cpu()
        lo, hi = start.to(dev)[:, None], (start + width).to(dev)[:, None]
        masked |= ((t_idx >= lo) & (t_idx < hi) & valid)[:, None, :]

    return torch.where(masked, torch.full_like(spect, mask_value), spect)
