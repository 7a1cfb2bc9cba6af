"""Host-side PCM helpers (numpy) in place of the removed ``audioop`` module.

A copy of ``danspeech_tpu.audio.dsp``: PCM decode/encode, RMS, byteswap,
stereo downmix, bias, sample-width and linear sample-rate conversion, each
matching ``audioop``; polyphase resampling, energy and an energy VAD; and
the G.711 mu-law codec of the engine's ``transfer_format="ulaw"``.
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


def resample_poly(x: np.ndarray, inrate: int, outrate: int) -> np.ndarray:
    """High-quality polyphase resampling of a float waveform.

    Preferred over linear interpolation when loading non-16 kHz files for
    recognition (the reference only offers audioop's linear ratecv).
    """
    from math import gcd

    from scipy.signal import resample_poly as _rp

    g = gcd(inrate, outrate)
    return _rp(np.asarray(x, dtype=np.float64), outrate // g, inrate // g)


def energy(x: np.ndarray) -> float:
    """RMS energy of a float waveform (video_transcribe_simulation.py:106 parity)."""
    x = np.asarray(x, dtype=np.float64)
    if x.size == 0:
        return 0.0
    return float(np.sqrt(np.mean(x * x)))


def energy_vad_segments(
    x: np.ndarray,
    sample_rate: int = 16000,
    step: int = 1024,
    energy_threshold: float = 700.0,
    max_pause_steps: int = 12,
    min_segment_samples: int | None = None,
) -> list[tuple[int, int]]:
    """Energy-endpointed (start, end) sample ranges of speech in a long
    recording — the hand-rolled VAD loop of the reference's long-form
    script (video_transcribe_simulation.py:100-143) as a reusable utility.

    Walks ``x`` in ``step``-sample hops; a hop is "speaking" when its RMS
    exceeds ``energy_threshold``; ``max_pause_steps`` silent hops end a
    segment; segments shorter than ``min_segment_samples`` (default 1 s)
    are dropped.

    ``x`` is expected at int16 sample scale — what every loader in
    :mod:`danspeech_tpu_torch.audio` returns and what the reference's energy
    loop thresholds (video_transcribe_simulation.py:99-101 computes RMS
    of raw ``load_audio`` samples against the default 700). A [-1, 1]
    normalized waveform must be scaled by 32767 by the caller (an earlier
    version scaled internally, which made every int16-scale hop read as
    speech and collapsed long recordings into one giant segment).
    """
    if min_segment_samples is None:
        min_segment_samples = sample_rate
    segments = []
    start = None
    pause = 0
    for it in range(0, max(0, len(x) - step), step):
        chunk = np.asarray(x[it : it + step], dtype=np.float64)
        speaking = float(np.sqrt(np.mean(chunk * chunk))) > energy_threshold
        if start is None:
            if speaking:
                start, pause = it, 0
        elif speaking:
            pause = 0
        else:
            pause += 1
            if pause > max_pause_steps:
                if it - start > min_segment_samples:
                    segments.append((start, it))
                start = None
    if start is not None and len(x) - start > min_segment_samples:
        segments.append((start, len(x)))
    return segments


def ulaw_encode(x: np.ndarray) -> np.ndarray:
    """G.711 mu-law encode int16 samples -> uint8 codes.

    Bit-exact with CPython's ``audioop.lin2ulaw(..., 2)`` (14-bit internal
    representation, arithmetic pre-shift). Used by the engine's opt-in
    ``transfer_format="ulaw"`` serving mode: one byte per sample over the
    host->device link, decoded on the device with the bit arithmetic of
    :func:`ulaw_decode_table` (``engine.ulaw_decode``).
    """
    x = np.asarray(x, np.int16).astype(np.int32) >> 2  # 14-bit, floor shift
    mask = np.where(x < 0, 0x7F, 0xFF)
    mag = np.where(x < 0, -x, x)
    mag = np.minimum(mag, 8159) + 33
    exp = np.frexp(mag.astype(np.float64))[1] - 6  # segment 0..8
    seg = np.minimum(exp, 7)
    uval = (seg << 4) | ((mag >> (seg + 1)) & 0xF)
    uval = np.where(exp >= 8, 0x7F, uval)
    return (uval ^ mask).astype(np.uint8)


def ulaw_decode_table() -> np.ndarray:
    """The 256-entry mu-law -> int16 decode table (audioop.ulaw2lin parity)."""
    code = (~np.arange(256, dtype=np.int32)) & 0xFF
    sign = code & 0x80
    exp = (code >> 4) & 7
    mant = code & 0x0F
    mag = (((mant << 3) + 0x84) << exp) - 0x84
    return np.where(sign, -mag, mag).astype(np.int16)
