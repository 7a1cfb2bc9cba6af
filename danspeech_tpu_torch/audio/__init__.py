"""Host-side audio I/O: loaders, PCM containers, DSP and capture sources
(copies of ``danspeech_tpu.audio``). Importing never needs PyAudio;
constructing a :class:`Microphone` does."""

from .io import (  # noqa: F401
    AudioData,
    SpeechFile,
    SpeechSource,
    load_audio,
    load_audio_pcm16,
    load_audio_wavPCM,
)
from .microphone import Microphone  # noqa: F401
