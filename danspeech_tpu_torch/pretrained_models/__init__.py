"""Pretrained acoustic-model zoo (the port of
``danspeech_tpu/pretrained_models``).

One constructor per published model: each fetches its ``.pth`` package
into the shared cache (md5-validated, ``utils/cache.py``) and loads it
with :meth:`DeepSpeechModel.load_model`. The same names, files, URLs and
md5s as the JAX package, with its fix of the original registry, where
``"GPUStreamingRNN"`` returned ``CPUStreamingRNN``.
"""

from __future__ import annotations

from ..models import DeepSpeechModel
from ..utils.cache import get_model

_RELEASE = "https://github.com/danspeech/danspeech/releases/download/v0.01-alpha"

_ZOO = {
    # name -> (filename, md5, description)
    "DanSpeechPrimary": (
        "DanSpeechPrimary.pth",
        "5bd08282d442e990c37481d5c61cf93c",
        "Deepest and best performing model: 3 conv, 9x1200 bidirectional GRU.",
    ),
    "TestModel": (
        "TestModel.pth",
        "c21438a33f847a9c8d4e08779e98bf31",
        "Fast smoke-test model (poor WER): 2 conv, 5x400 bidirectional GRU.",
    ),
    "Baseline": (
        "Baseline.pth",
        "e2c0c16d518fc57cd61c86cbb0170660",
        "Baseline: 2 conv, 5x800 bidirectional GRU.",
    ),
    "TransferLearned": (
        "TransferLearned.pth",
        "d19b9d7dc976bffbc9225e0f80ecacbf",
        "Best on noisy data: 2 conv, 5x800 bidirectional GRU, fine-tuned.",
    ),
    "Folketinget": (
        "Folketinget.pth",
        "9523d5744ad4ff5ffc8519393350cc91",
        "Parliament fine-tune: 3 conv, 9x1200 bidirectional GRU.",
    ),
    "EnglishLibrispeech": (
        "Librispeech.pth",
        "56630094905e7308f42ae0f82421440b",
        "English Librispeech model: 2 conv, 5x800 bidirectional GRU.",
    ),
    "CPUStreamingRNN": (
        "CPUStreamingRNN.pth",
        "ba514ec96b511c0797dc643190a80269",
        "Real-time streaming model (CPU-sized): 2 conv, 5x800 uni GRU + lookahead 20.",
    ),
    "GPUStreamingRNN": (
        "GPUStreamingRNN.pth",
        "8194f47f5c63c14c3587d42aa37d622d",
        "Real-time streaming model (large): 2 conv, 5x2000 uni GRU + lookahead 20.",
    ),
}


def _load(name: str, cache_dir=None) -> DeepSpeechModel:
    filename, md5, _ = _ZOO[name]
    path = get_model(
        model_name=filename,
        origin=f"{_RELEASE}/{filename}",
        file_hash=md5,
        cache_dir=cache_dir,
    )
    return DeepSpeechModel.load_model(path)


def DanSpeechPrimary(cache_dir=None) -> DeepSpeechModel:
    """Deepest and best performing model (3 conv, 9x1200 bidi GRU)."""
    return _load("DanSpeechPrimary", cache_dir)


def TestModel(cache_dir=None) -> DeepSpeechModel:
    """Fast test model; performance is very bad (2 conv, 5x400 bidi GRU)."""
    return _load("TestModel", cache_dir)


def Baseline(cache_dir=None) -> DeepSpeechModel:
    """Baseline model (2 conv, 5x800 bidi GRU)."""
    return _load("Baseline", cache_dir)


def TransferLearned(cache_dir=None) -> DeepSpeechModel:
    """Transfer-learned model, best on noisy data (2 conv, 5x800 bidi GRU)."""
    return _load("TransferLearned", cache_dir)


def Folketinget(cache_dir=None) -> DeepSpeechModel:
    """Folketinget (parliament) fine-tuned model (3 conv, 9x1200 bidi GRU)."""
    return _load("Folketinget", cache_dir)


def EnglishLibrispeech(cache_dir=None) -> DeepSpeechModel:
    """English Librispeech model (2 conv, 5x800 bidi GRU)."""
    return _load("EnglishLibrispeech", cache_dir)


def CPUStreamingRNN(cache_dir=None) -> DeepSpeechModel:
    """Streaming model for real-time CPU use (uni GRU + lookahead)."""
    return _load("CPUStreamingRNN", cache_dir)


def GPUStreamingRNN(cache_dir=None) -> DeepSpeechModel:
    """Streaming model, larger hidden size (uni GRU + lookahead)."""
    return _load("GPUStreamingRNN", cache_dir)


def CustomModel(model_path) -> DeepSpeechModel:
    """Load a custom model from a local path (.pth or .dsz)."""
    return DeepSpeechModel.load_model(model_path)


def get_model_from_string(model_name: str):
    """Registry lookup by name (reference pretrained_models/__init__.py:12-30)."""
    registry = {
        "DanSpeechPrimary": DanSpeechPrimary,
        "TestModel": TestModel,
        "Baseline": Baseline,
        "CPUStreamingRNN": CPUStreamingRNN,
        "GPUStreamingRNN": GPUStreamingRNN,
        "Folketinget": Folketinget,
        "TransferLearned": TransferLearned,
        "EnglishLibrispeech": EnglishLibrispeech,
    }
    ctor = registry.get(model_name)
    return ctor() if ctor else None
