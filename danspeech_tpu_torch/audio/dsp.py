"""Host-side PCM helpers (numpy) in place of the removed ``audioop`` module.

A copy of the parts of ``danspeech_tpu.audio.dsp`` that the audio loaders
use: PCM decode/encode, RMS, byteswap, stereo downmix, bias, sample-width
and linear sample-rate conversion, each matching ``audioop``.
"""

from __future__ import annotations

import numpy as np

_WIDTH_DTYPES = {1: np.int8, 2: np.int16, 4: np.int32}


def pcm_to_int_array(data: bytes, sample_width: int) -> np.ndarray:
    """Decode little-endian signed PCM bytes into an int32 numpy array.

    24-bit samples (width 3) are sign-extended into int32
    (reference resources.py:142-171 `_wav2array`).
    """
    if sample_width == 3:
        raw = np.frombuffer(data, dtype=np.uint8)
        if raw.size % 3:
            raise ValueError("PCM byte length is not a multiple of sample width")
        raw = raw.reshape(-1, 3)
        a = np.empty((raw.shape[0], 4), dtype=np.uint8)
        a[:, :3] = raw
        a[:, 3] = (raw[:, 2].astype(np.int8) >> 7).astype(np.uint8)
        return a.view("<i4").reshape(-1).astype(np.int32)
    dtype = _WIDTH_DTYPES.get(sample_width)
    if dtype is None:
        raise ValueError(f"Unsupported sample width: {sample_width}")
    arr = np.frombuffer(data, dtype=np.dtype(dtype).newbyteorder("<"))
    return arr.astype(np.int32)


def int_array_to_pcm(arr: np.ndarray, sample_width: int) -> bytes:
    """Encode an integer array as little-endian signed PCM bytes (clipped)."""
    info_bits = 8 * sample_width
    lo, hi = -(1 << (info_bits - 1)), (1 << (info_bits - 1)) - 1
    arr = np.clip(np.asarray(arr), lo, hi).astype(np.int64)
    if sample_width == 3:
        u = (arr & 0xFFFFFF).astype(np.uint32)
        out = np.empty((arr.size, 3), dtype=np.uint8)
        out[:, 0] = u & 0xFF
        out[:, 1] = (u >> 8) & 0xFF
        out[:, 2] = (u >> 16) & 0xFF
        return out.tobytes()
    dtype = np.dtype(_WIDTH_DTYPES[sample_width]).newbyteorder("<")
    return arr.astype(dtype).tobytes()


def rms(data: bytes, sample_width: int) -> int:
    """Root-mean-square energy of a PCM buffer (audioop.rms parity).

    Used by the VAD energy endpointing loops (reference Recognizer.py:174,198).
    """
    if not data:
        return 0
    samples = pcm_to_int_array(data, sample_width).astype(np.float64)
    return int(np.sqrt(np.mean(samples * samples)))


def byteswap(data: bytes, sample_width: int) -> bytes:
    """Swap endianness of every sample (audioop.byteswap parity)."""
    raw = np.frombuffer(data, dtype=np.uint8)
    if raw.size % sample_width:
        raise ValueError("PCM byte length is not a multiple of sample width")
    return raw.reshape(-1, sample_width)[:, ::-1].tobytes()


def tomono(data: bytes, sample_width: int, lfactor: float = 1.0, rfactor: float = 1.0) -> bytes:
    """Mix interleaved stereo PCM down to mono (audioop.tomono parity).

    ``audioop.tomono`` computes ``l*lfactor/1 + r*rfactor`` per frame with
    int truncation toward zero; we match that to keep loaders bit-identical
    (reference resources.py:303).
    """
    samples = pcm_to_int_array(data, sample_width)
    if samples.size % 2:
        raise ValueError("Stereo PCM must have an even number of samples")
    stereo = samples.reshape(-1, 2).astype(np.float64)
    mixed = stereo[:, 0] * lfactor + stereo[:, 1] * rfactor
    mixed = np.trunc(mixed)
    return int_array_to_pcm(mixed, sample_width)


def bias(data: bytes, sample_width: int, offset: int) -> bytes:
    """Add a constant to every sample, wrapping on overflow (audioop.bias parity)."""
    samples = pcm_to_int_array(data, sample_width).astype(np.int64) + offset
    bits = 8 * sample_width
    samples = ((samples + (1 << (bits - 1))) % (1 << bits)) - (1 << (bits - 1))
    return int_array_to_pcm(samples, sample_width)


def lin2lin(data: bytes, sample_width: int, new_width: int) -> bytes:
    """Convert between PCM sample widths by bit-shifting (audioop.lin2lin parity)."""
    if sample_width == new_width:
        return data
    samples = pcm_to_int_array(data, sample_width).astype(np.int64)
    shift = 8 * (new_width - sample_width)
    samples = samples << shift if shift > 0 else samples >> -shift
    return int_array_to_pcm(samples, new_width)


def ratecv_linear(
    data: bytes, sample_width: int, nchannels: int, inrate: int, outrate: int
) -> bytes:
    """Linear-interpolation sample-rate conversion.

    Matches the quality class of ``audioop.ratecv`` used by the reference
    (resources.py:570) — output sample k sits at input position
    ``k * inrate/outrate`` and is linearly interpolated between neighbors.
    """
    if inrate == outrate:
        return data
    samples = pcm_to_int_array(data, sample_width).astype(np.float64)
    if nchannels > 1:
        samples = samples.reshape(-1, nchannels)
    else:
        samples = samples.reshape(-1, 1)
    n_in = samples.shape[0]
    n_out = int(n_in * outrate / inrate)
    pos = np.arange(n_out, dtype=np.float64) * (inrate / outrate)
    idx = np.minimum(pos.astype(np.int64), n_in - 1)
    nxt = np.minimum(idx + 1, n_in - 1)
    frac = (pos - idx)[:, None]
    out = samples[idx] * (1.0 - frac) + samples[nxt] * frac
    return int_array_to_pcm(np.round(out).reshape(-1), sample_width)
