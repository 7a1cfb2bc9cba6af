"""Analysis windows matching the original danspeech's scipy.signal defaults.

The original builds windows via ``scipy.signal.{hamming,hann,blackman,
bartlett}``, which are *symmetric* (sym=True) — note this differs from the
periodic (fftbins=True) windows librosa uses for string window names. Since
the original passes the callables directly, librosa calls ``window(n_fft)``
and gets the symmetric variant; we reproduce that.
"""

from __future__ import annotations

import numpy as np


def hamming(M: int) -> np.ndarray:
    if M == 1:
        return np.ones(1)
    n = np.arange(M)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (M - 1))


def hann(M: int) -> np.ndarray:
    if M == 1:
        return np.ones(1)
    n = np.arange(M)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (M - 1))


def blackman(M: int) -> np.ndarray:
    if M == 1:
        return np.ones(1)
    n = np.arange(M)
    return (
        0.42
        - 0.5 * np.cos(2.0 * np.pi * n / (M - 1))
        + 0.08 * np.cos(4.0 * np.pi * n / (M - 1))
    )


def bartlett(M: int) -> np.ndarray:
    if M == 1:
        return np.ones(1)
    n = np.arange(M)
    return 1.0 - np.abs(2.0 * n / (M - 1) - 1.0)


WINDOWS = {
    "hamming": hamming,
    "hann": hann,
    "blackman": blackman,
    "bartlett": bartlett,
}


def get_window(name: str, M: int) -> np.ndarray:
    try:
        return WINDOWS[name](M)
    except KeyError:
        raise ValueError(
            f"Unknown window {name!r}; supported: {sorted(WINDOWS)}"
        ) from None
