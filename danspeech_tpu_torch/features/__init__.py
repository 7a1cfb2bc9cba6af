from .spectrogram import (  # noqa: F401
    AudioParser,
    InferenceSpectrogramAudioParser,
    SpectrogramAudioParser,
    get_default_audio_config,
)
from .windows import get_window  # noqa: F401
