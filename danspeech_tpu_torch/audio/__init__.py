"""Host-side audio I/O: loaders, PCM containers and DSP (copies of
``danspeech_tpu.audio``; microphone capture comes with a later slice)."""

from .io import (  # noqa: F401
    AudioData,
    SpeechFile,
    SpeechSource,
    load_audio,
    load_audio_pcm16,
    load_audio_wavPCM,
)
