"""danspeech_tpu_torch — the PyTorch + CUDA port of danspeech_tpu.

Imports torch, numpy and scipy only: never JAX and nothing of
``danspeech_tpu``. Entry points run on CUDA unless given ``device="cpu"``.
"""

from .engine import DanSpeechRecognizer  # noqa: F401
from .multistream import MultiStreamTranscriber  # noqa: F401
from .recognizer import Recognizer  # noqa: F401
from .utils.cache import clean_cache  # noqa: F401

__version__ = "0.1.0"
