"""Audio file loading and the AudioData container.

A copy of ``danspeech_tpu.audio.io``: the original danspeech audio I/O
layer (``danspeech/audio/resources.py``) without the deprecated
``audioop``/``aifc`` stdlib modules: WAV via ``wave``, AIFF via a small IFF
parser, FLAC via the bundled from-scratch decoder, stereo downmix and rate
conversion via :mod:`danspeech_tpu_torch.audio.dsp`.
"""

from __future__ import annotations

import io
import os
import struct
import warnings
import wave
from abc import ABC

import numpy as np

from . import dsp


class SamplingRateWarning(Warning):
    pass


# ---------------------------------------------------------------------------
# AIFF parsing (replaces the deprecated stdlib `aifc` used at resources.py:212)
# ---------------------------------------------------------------------------


def _read_ext_float80(b: bytes) -> float:
    """Decode an 80-bit IEEE 754 extended float (AIFF sample-rate field)."""
    sign = b[0] >> 7
    exponent = ((b[0] & 0x7F) << 8) | b[1]
    mantissa = int.from_bytes(b[2:10], "big")
    if exponent == 0 and mantissa == 0:
        return 0.0
    value = mantissa * 2.0 ** (exponent - 16383 - 63)
    return -value if sign else value


def parse_aiff(data: bytes):
    """Parse AIFF/AIFF-C bytes -> (nchannels, sampwidth, framerate, pcm_bytes).

    PCM bytes are returned in native big-endian order, mirroring what the
    reference reads through ``aifc`` before byteswapping (resources.py:291-299).
    Only uncompressed ("NONE"/"sowt") AIFF-C is supported.
    """
    if len(data) < 12 or data[:4] != b"FORM" or data[8:12] not in (b"AIFF", b"AIFC"):
        raise ValueError("Not an AIFF file")
    is_aifc = data[8:12] == b"AIFC"
    pos = 12
    comm = None
    ssnd = None
    little_endian = False
    while pos + 8 <= len(data):
        ckid = data[pos : pos + 4]
        (size,) = struct.unpack(">I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + size]
        if ckid == b"COMM":
            nchannels, nframes = struct.unpack(">hI", body[0:6])
            (sampsize,) = struct.unpack(">h", body[6:8])
            framerate = _read_ext_float80(body[8:18])
            if is_aifc and len(body) >= 22:
                compression = body[18:22]
                if compression == b"sowt":
                    little_endian = True
                elif compression not in (b"NONE",):
                    raise ValueError(
                        f"Unsupported AIFF-C compression: {compression!r}"
                    )
            comm = (nchannels, (sampsize + 7) // 8, int(framerate), nframes)
        elif ckid == b"SSND":
            (offset, _blocksize) = struct.unpack(">II", body[0:8])
            ssnd = body[8 + offset :]
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if comm is None or ssnd is None:
        raise ValueError("AIFF file missing COMM or SSND chunk")
    nchannels, sampwidth, framerate, nframes = comm
    pcm = ssnd[: nframes * nchannels * sampwidth]
    if not little_endian and sampwidth > 1:
        pcm = dsp.byteswap(pcm, sampwidth)
    return nchannels, sampwidth, framerate, pcm


# ---------------------------------------------------------------------------
# AudioData
# ---------------------------------------------------------------------------


class AudioData:
    """Mono PCM audio held as a bytestring (reference resources.py:495-640).

    ``get_array_data`` produces the float numpy waveform consumed by the
    feature extractor; conversion helpers mirror the reference semantics.
    """

    def __init__(self, frame_data: bytes, sample_rate: int, sample_width: int):
        assert sample_rate > 0, "Sample rate must be a positive integer"
        assert sample_width % 1 == 0 and 1 <= sample_width <= 4, (
            "Sample width must be between 1 and 4 inclusive"
        )
        self.frame_data = frame_data
        self.sample_rate = sample_rate
        self.sample_width = int(sample_width)

    def get_segment(self, start_ms=None, end_ms=None) -> "AudioData":
        """Trim to a [start_ms, end_ms) interval (resources.py:516-541)."""
        assert start_ms is None or start_ms >= 0
        assert end_ms is None or end_ms >= (0 if start_ms is None else start_ms)
        start_byte = (
            0
            if start_ms is None
            else int((start_ms * self.sample_rate * self.sample_width) // 1000)
        )
        end_byte = (
            len(self.frame_data)
            if end_ms is None
            else int((end_ms * self.sample_rate * self.sample_width) // 1000)
        )
        return AudioData(
            self.frame_data[start_byte:end_byte], self.sample_rate, self.sample_width
        )

    def get_raw_data(self, convert_rate=None, convert_width=None) -> bytes:
        """Raw little-endian PCM, optionally rate/width converted
        (resources.py:543-599)."""
        assert convert_rate is None or convert_rate > 0
        assert convert_width is None or (1 <= convert_width <= 4)

        raw_data = self.frame_data
        # unsigned 8-bit -> signed
        if self.sample_width == 1:
            raw_data = dsp.bias(raw_data, 1, -128)

        if convert_rate is not None and self.sample_rate != convert_rate:
            raw_data = dsp.ratecv_linear(
                raw_data, self.sample_width, 1, self.sample_rate, convert_rate
            )

        if convert_width is not None and self.sample_width != convert_width:
            raw_data = dsp.lin2lin(raw_data, self.sample_width, convert_width)

        # signed -> unsigned 8-bit on the way out
        if convert_width == 1:
            raw_data = dsp.bias(raw_data, 1, 128)
        return raw_data

    def get_wav_data(self, convert_rate=None, convert_width=None) -> bytes:
        """Contents of a valid mono WAV file (resources.py:601-628)."""
        raw_data = self.get_raw_data(convert_rate, convert_width)
        sample_rate = convert_rate or self.sample_rate
        sample_width = convert_width or self.sample_width
        with io.BytesIO() as wav_file:
            writer = wave.open(wav_file, "wb")
            try:
                writer.setframerate(sample_rate)
                writer.setsampwidth(sample_width)
                writer.setnchannels(1)
                writer.writeframes(raw_data)
                wav_data = wav_file.getvalue()
            finally:
                writer.close()
        return wav_data

    def get_array_data(self, convert_rate=None, convert_width=None) -> np.ndarray:
        """Float waveform ready for recognition (resources.py:630-640)."""
        raw_data = self.get_raw_data(convert_rate, convert_width)
        sample_width = convert_width or self.sample_width
        return dsp.pcm_to_int_array(raw_data, sample_width).astype(float)


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------


class SpeechSource(ABC):
    """Anything the Recognizer can listen to: files, microphones."""


class SpeechFile(SpeechSource):
    """Context-managed, chunk-streamed file source (resources.py:181-304).

    Tries WAV, then AIFF, then FLAC — converting to mono little-endian PCM on
    the fly so the listen loops see a uniform stream interface.
    """

    def __init__(self, filepath):
        self.filepath = filepath
        self.sampling_rate = 16000
        self.duration = None
        self.chunk = None
        self.frame_count = None
        self.stream = None
        self.sampling_width = None
        self.source_rate = None

    def __enter__(self):
        if hasattr(self.filepath, "read"):
            data = self.filepath.read()
        else:
            with open(self.filepath, "rb") as f:
                data = f.read()

        nchannels = sampwidth = framerate = None
        pcm = None
        try:
            with wave.open(io.BytesIO(data), "rb") as reader:
                nchannels = reader.getnchannels()
                sampwidth = reader.getsampwidth()
                framerate = reader.getframerate()
                pcm = reader.readframes(reader.getnframes())
        except (wave.Error, EOFError):
            try:
                nchannels, sampwidth, framerate, pcm = parse_aiff(data)
            except ValueError:
                try:
                    from .flac import decode_flac

                    nchannels, sampwidth, framerate, pcm = decode_flac(data)
                except ValueError:
                    raise ValueError(
                        "Audio file could not be read as PCM WAV, AIFF/AIFF-C, or "
                        "native FLAC; check if the file is corrupted or in another "
                        "format"
                    ) from None

        assert 1 <= nchannels <= 2, "Audio must be mono or stereo"
        if nchannels == 2:
            pcm = dsp.tomono(pcm, sampwidth, 1, 1)

        if framerate != self.sampling_rate:
            warnings.warn(
                f"File {self.filepath} has sampling rate {framerate}. danspeech "
                f"models expect 16000; the stream will resample on the fly.",
                SamplingRateWarning,
            )
        self.source_rate = framerate
        self.sampling_width = sampwidth
        self.chunk = 4096
        self.frame_count = len(pcm) // sampwidth
        self.duration = self.frame_count / float(framerate)
        self.stream = _PCMStream(pcm, sampwidth)
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.stream = None
        self.duration = None


class _PCMStream:
    """Chunked reader over an in-memory mono PCM buffer."""

    def __init__(self, pcm: bytes, sample_width: int):
        self._pcm = pcm
        self._width = sample_width
        self._pos = 0

    def read(self, size: int = -1) -> bytes:
        if size == -1:
            out = self._pcm[self._pos :]
            self._pos = len(self._pcm)
            return out
        nbytes = size * self._width
        out = self._pcm[self._pos : self._pos + nbytes]
        self._pos += len(out)
        return out


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------


def load_audio(path, duration=None, offset=None) -> np.ndarray:
    """Load WAV/AIFF/FLAC into a float waveform (resources.py:22-61).

    Reads through the chunked SpeechFile stream with optional offset/duration
    windows measured in seconds, then resamples to 16 kHz if needed.
    """
    with SpeechFile(filepath=path) as source:
        frames_bytes = io.BytesIO()
        seconds_per_buffer = float(source.chunk) / source.source_rate
        elapsed_time = 0.0
        offset_time = 0.0
        offset_reached = False
        while True:
            if offset and not offset_reached:
                offset_time += seconds_per_buffer
                if offset_time > offset:
                    offset_reached = True

            buffer = source.stream.read(source.chunk)
            if len(buffer) == 0:
                break

            if offset_reached or not offset:
                elapsed_time += seconds_per_buffer
                if duration and elapsed_time > duration:
                    break
                frames_bytes.write(buffer)

        frame_data = frames_bytes.getvalue()
        frames_bytes.close()
        audio = AudioData(frame_data, source.source_rate, source.sampling_width)
        if source.source_rate != source.sampling_rate:
            return audio.get_array_data(convert_rate=source.sampling_rate)
        return audio.get_array_data()


def load_audio_wavPCM(path) -> np.ndarray:
    """Fast path for PCM WAV files (resources.py:64-82).

    Stereo inputs are downmixed by channel mean, matching the reference's
    scipy-based loader.
    """
    import scipy.io.wavfile as wavfile

    _, sound = wavfile.read(path)
    if sound.ndim > 1:
        if sound.shape[1] == 1:
            sound = sound.squeeze()
        else:
            sound = sound.mean(axis=1)
    return sound.astype(float)


def load_audio_pcm16(path) -> np.ndarray:
    """Load a 16-bit PCM WAV as int16 — the serving-path fast loader.

    int16 waveforms cross the host->device link at half the bytes of the
    float path (the engine stages int16 batches verbatim and casts on
    device). Stereo is downmixed by rounded channel mean, which quantizes
    half-sample means to the nearest LSB (<= 0.5 LSB difference vs the
    reference's float mean, resources.py:64-82 — inaudible and invisible
    to the decoder); use :func:`load_audio_wavPCM` for bit-exact float
    parity work.
    """
    import scipy.io.wavfile as wavfile

    rate, sound = wavfile.read(path)
    # a 44.1 kHz file silently treated as 16 kHz transcribes garbage —
    # this loader already validates dtype, so validate rate too (the
    # parity loader load_audio_wavPCM keeps the reference's rate-blind
    # behavior, resources.py:64-82)
    if rate != 16000:
        raise ValueError(
            f"{path}: sample rate {rate} != 16000; resample first "
            "(danspeech models are 16 kHz)"
        )
    # dtype check BEFORE the downmix cast: a float/int32 stereo file must
    # raise, not get silently quantized to garbage by the int16 cast
    if sound.dtype != np.int16:
        raise ValueError(
            f"{path}: not 16-bit PCM (got {sound.dtype}); "
            "use load_audio_wavPCM"
        )
    if sound.ndim > 1:
        if sound.shape[1] == 1:
            sound = sound.squeeze()
        else:
            sound = np.rint(sound.mean(axis=1)).astype(np.int16)
    return sound
