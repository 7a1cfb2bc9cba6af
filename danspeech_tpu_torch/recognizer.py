"""Public Recognizer API (batch recognition).

The port of the one-shot part of ``danspeech_tpu/recognizer.py``: the
same constructor, tuning attributes and ``recognize`` /
``recognize_batch`` / ``update_model``. Listening, VAD and streaming come
with later slices.
"""

from __future__ import annotations

from .engine import DanSpeechRecognizer
from .errors import ModelNotInitialized


class Recognizer:
    """A collection of speech-recognition functionality.

    Construct with an optional model; keyword arguments go to
    :class:`DanSpeechRecognizer` (``device=None`` means CUDA,
    ``device="cpu"`` the CPU).
    """

    def __init__(self, model=None, lm=None, with_gpu=False, **kwargs):
        # VAD / endpointing tuning (the original defaults), kept for the
        # listen loops of a later slice
        self.energy_threshold = 1000
        self.pause_threshold = 0.8
        self.phrase_threshold = 0.3
        self.non_speaking_duration = 0.35
        self.mininum_required_speaking_seconds = 0.7
        self.dynamic_energy_threshold = True
        self.dynamic_energy_adjustment_damping = 0.15
        self.dynamic_energy_ratio = 1.5

        self.danspeech_recognizer = DanSpeechRecognizer(with_gpu=with_gpu, **kwargs)

        if model:
            self.update_model(model)
        if lm:
            if not model:
                raise ModelNotInitialized(
                    "Trying to initialize language model without also choosing an "
                    "acoustic model."
                )
            self.update_decoder(lm=lm)

    def recognize(self, audio_data, show_all: bool = False):
        """Transcribe one waveform."""
        return self.danspeech_recognizer.transcribe(audio_data, show_all=show_all)

    def recognize_batch(self, audio_batch, show_all: bool = False):
        """Transcribe a list of waveforms in bucketed device batches."""
        return self.danspeech_recognizer.transcribe_batch(
            audio_batch, show_all=show_all
        )

    def update_model(self, model) -> None:
        self.danspeech_recognizer.update_model(model)
        print(f"Model updated to: {model.model_name}")

    def update_decoder(self, lm=None, alpha=None, beta=None, beam_width=None):
        self.danspeech_recognizer.update_decoder(
            lm=lm, alpha=alpha, beta=beta, beam_width=beam_width
        )
