"""FLAC decoding via the from-scratch native decoder (native/flacdec).

Replaces the original danspeech's bundled GPL flac binaries + subprocess
pipeline. Host-side only. A copy of ``danspeech_tpu.audio.flac``: it loads
the same C library (``native/build/libflacdec.so``, built by
``make -C native``) with ctypes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SO_PATH = os.path.join(_NATIVE_DIR, "build", "libflacdec.so")

_lib = None


def _load_lib():
    global _lib
    if _lib is None:
        if not os.path.exists(_SO_PATH):
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "build/libflacdec.so"],
                check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(_SO_PATH)
        lib.flacdec_info.restype = ctypes.c_int
        lib.flacdec_info.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.flacdec_decode.restype = ctypes.c_int64
        lib.flacdec_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
        ]
        _lib = lib
    return _lib


def decode_flac(data: bytes):
    """Decode FLAC bytes -> (nchannels, sampwidth, framerate, pcm_le_bytes).

    Raises ValueError if ``data`` is not a FLAC stream, RuntimeError on a
    corrupt stream.
    """
    if len(data) < 4 or data[:4] != b"fLaC":
        raise ValueError("Not a FLAC file")
    lib = _load_lib()

    rate = ctypes.c_int32()
    channels = ctypes.c_int32()
    bps = ctypes.c_int32()
    total = ctypes.c_int64()
    rc = lib.flacdec_info(
        data, len(data),
        ctypes.byref(rate), ctypes.byref(channels),
        ctypes.byref(bps), ctypes.byref(total),
    )
    if rc != 0:
        raise RuntimeError(f"Failed to parse FLAC STREAMINFO (rc={rc})")

    if total.value > 0:
        capacity = total.value * channels.value
    else:
        # unknown length: upper-bound by compressed size (FLAC never expands
        # PCM beyond ~1x + small headers; 2x is a safe ceiling)
        capacity = max(len(data) * 2 // 2, 1 << 20)
    out = np.zeros(capacity, dtype=np.int32)
    n = lib.flacdec_decode(data, len(data), out, capacity)
    if n < 0:
        raise RuntimeError(f"FLAC decode failed (rc={n})")
    if total.value > 0 and n < total.value:
        raise RuntimeError(
            f"Truncated FLAC stream: decoded {n}/{total.value} samples"
        )

    samples = out[: n * channels.value]
    sampwidth = (bps.value + 7) // 8
    from . import dsp

    pcm = dsp.int_array_to_pcm(samples, sampwidth)
    return int(channels.value), sampwidth, int(rate.value), pcm
