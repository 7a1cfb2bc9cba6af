"""Microphone capture source (a copy of ``danspeech_tpu/audio/microphone.py``).

PyAudio/PortAudio is optional: importing this module never fails, but
constructing a :class:`Microphone` without PyAudio installed raises with a
clear message. The stream interface matches :class:`SpeechFile`'s so the
Recognizer listen loops are source-agnostic.
"""

from __future__ import annotations

from .io import SpeechSource


def _get_pyaudio():
    try:
        import pyaudio
    except ImportError:
        raise AttributeError(
            "Could not find PyAudio; microphone capture requires the pyaudio "
            "package (and the PortAudio system library)."
        ) from None
    return pyaudio


class Microphone(SpeechSource):
    """A system microphone as a chunked 16-bit PCM stream source.

    Defaults mirror the original package: 16 kHz, 1024-frame chunks, 16-bit mono.
    """

    def __init__(self, device_index=None, sampling_rate=16000, chunk_size=1024):
        assert device_index is None or isinstance(device_index, int)
        assert sampling_rate is None or (
            isinstance(sampling_rate, int) and sampling_rate > 0
        )
        assert isinstance(chunk_size, int) and chunk_size > 0

        self.pyaudio_module = _get_pyaudio()
        audio = self.pyaudio_module.PyAudio()
        try:
            count = audio.get_device_count()
            if device_index is not None:
                assert 0 <= device_index < count, (
                    f"Device index out of range ({count} devices available; device "
                    f"index should be between 0 and {count - 1} inclusive)"
                )
            if sampling_rate is None:
                device_info = (
                    audio.get_device_info_by_index(device_index)
                    if device_index is not None
                    else audio.get_default_input_device_info()
                )
                sampling_rate = int(device_info["defaultSampleRate"])
        finally:
            audio.terminate()

        self.device_index = device_index
        self.format = self.pyaudio_module.paInt16
        self.sampling_width = self.pyaudio_module.get_sample_size(self.format)
        self.sampling_rate = sampling_rate
        self.source_rate = sampling_rate
        self.chunk = chunk_size
        self.audio = None
        self.stream = None

    @staticmethod
    def list_microphone_names():
        """Names of all input devices, indexable as ``device_index``."""
        audio = _get_pyaudio().PyAudio()
        try:
            return [
                audio.get_device_info_by_index(i).get("name")
                for i in range(audio.get_device_count())
            ]
        finally:
            audio.terminate()

    def __enter__(self):
        assert self.stream is None, "This audio source is already inside a context manager"
        self.audio = self.pyaudio_module.PyAudio()
        try:
            self.stream = Microphone.MicrophoneStream(
                self.audio.open(
                    input_device_index=self.device_index,
                    channels=1,
                    format=self.format,
                    rate=self.sampling_rate,
                    frames_per_buffer=self.chunk,
                    input=True,
                )
            )
        except Exception:
            self.audio.terminate()
            raise
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        try:
            self.stream.close()
        finally:
            self.stream = None
            self.audio.terminate()

    class MicrophoneStream:
        def __init__(self, pyaudio_stream):
            self.pyaudio_stream = pyaudio_stream

        def read(self, size):
            return self.pyaudio_stream.read(size, exception_on_overflow=False)

        def close(self):
            try:
                if not self.pyaudio_stream.is_stopped():
                    self.pyaudio_stream.stop_stream()
            finally:
                self.pyaudio_stream.close()
