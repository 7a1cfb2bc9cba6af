"""Isolation of the PyTorch port: it imports neither JAX (nor optax, nor
orbax) nor anything of ``danspeech_tpu``, and its entry points run on CUDA
unless told otherwise."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from danspeech_tpu_torch import Recognizer as TRecognizer
from danspeech_tpu_torch.engine import DanSpeechRecognizer as TRecognizerEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_package_imports_no_jax():
    """The port imports neither JAX nor anything of danspeech_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import danspeech_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import danspeech_tpu_torch.train.__main__\n"
        "need = ['ctc', 'augment', 'data', 'step', 'checkpoint', 'loop']\n"
        "missing = [n for n in need if 'danspeech_tpu_torch.train.' + n "
        "not in sys.modules]\n"
        "assert not missing, missing\n"
        "for n in ('audio.microphone', 'utils.profiling', 'utils.cache', "
        "'utils.logging', 'multistream', 'pretrained_models', "
        "'language_models', 'models.torch_pickle'):\n"
        "    assert 'danspeech_tpu_torch.' + n in sys.modules, n\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'danspeech_tpu', 'pyaudio')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_is_cuda():
    """device=None means CUDA: without a GPU the engine raises."""
    if torch.cuda.is_available():
        assert TRecognizerEngine().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TRecognizerEngine()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TRecognizer()


def test_model_entry_points_default_to_cuda():
    """A recognizer given a model and the multi-stream transcriber run on
    CUDA when no device is named: without a GPU both raise."""
    from danspeech_tpu_torch import MultiStreamTranscriber
    from danspeech_tpu_torch.models import DeepSpeechModel
    from danspeech_tpu_torch.models.config import DeepSpeechConfig

    model = DeepSpeechModel.init_random(DeepSpeechConfig(
        rnn_hidden_size=8, rnn_layers=1, conv_layers=2, bidirectional=False))
    if torch.cuda.is_available():
        assert MultiStreamTranscriber(model, n_streams=2).device.type == "cuda"
        assert TRecognizer(model=model).danspeech_recognizer.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MultiStreamTranscriber(model, n_streams=2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TRecognizer(model=model)


FOREIGN = {"jax", "jaxlib", "optax", "orbax", "danspeech_tpu"}


def _imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_name_no_foreign_import():
    """No import statement of the port or of chip_smoke.py, at any depth of
    any function, names JAX, optax, orbax or the JAX package."""
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "danspeech_tpu_torch")):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert any(p.endswith(os.path.join("train", "loop.py")) for p in sources)
    for module in ("lstm_cuda.py", "rnn_tanh_cuda.py", "cuda_checks.py"):
        assert any(p.endswith(os.path.join("ops", module)) for p in sources), module
    for path in sources:
        assert not (_imported_roots(path) & FOREIGN), path


def test_training_default_device_is_cuda():
    """train state and loop: device=None means CUDA and raises without a GPU."""
    from danspeech_tpu_torch.models.config import DeepSpeechConfig
    from danspeech_tpu_torch.train import init_train_state, make_optimizer

    config = DeepSpeechConfig(rnn_hidden_size=8, rnn_layers=1, conv_layers=1)
    if torch.cuda.is_available():
        state = init_train_state(config, make_optimizer())
        assert state.params["fc"].weight.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_train_state(config, make_optimizer())


def test_every_kernel_has_a_source_a_plain_version_and_a_counter():
    """Each of the nine wrappers has its plain version beside it and a
    ``launches`` counter; the CUDA sources they name exist, and no source
    lies under csrc/ without a wrapper."""
    from danspeech_tpu_torch.ops import cuda_build, gru_cuda, lstm_cuda, rnn_tanh_cuda

    kernels = {
        gru_cuda: {"gru_bidi_fused": "gru_bidi_fused", "gru_scan": "gru_scan",
                   "gru_scan_bidi": "gru_scan_bidi", "gru_bwd_scan": "gru_bwd"},
        lstm_cuda: {"lstm_scan": "lstm_scan", "lstm_scan_with_cell": "lstm_scan",
                    "lstm_bwd_scan": "lstm_bwd"},
        rnn_tanh_cuda: {"rnn_tanh_scan": "rnn_tanh_scan",
                        "rnn_tanh_bwd_scan": "rnn_tanh_bwd"},
    }
    sources = set()
    for module, names in kernels.items():
        for name, source in names.items():
            assert callable(getattr(module, f"{name}_plain")), name
            assert isinstance(getattr(module, name).launches, int), name
            assert os.path.isfile(os.path.join(cuda_build.CSRC_DIR, f"{source}.cu")), source
            sources.add(f"{source}.cu")
    on_disk = {f for f in os.listdir(cuda_build.CSRC_DIR) if f.endswith(".cu")}
    assert on_disk == sources


def test_decode_modules_are_walked_and_import_builds_nothing():
    """The LM and beam modules are part of the walk, and importing them
    (and the engine) starts no compiler: the C++ beam decoder is built at
    its first use."""
    code = (
        "import subprocess, sys\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a process was started at import')\n"
        "subprocess.run = subprocess.Popen = subprocess.call = refuse\n"
        "import danspeech_tpu_torch.engine\n"
        "import danspeech_tpu_torch.decode as d\n"
        "from danspeech_tpu_torch.decode import (beam, beam_auto, device_beam,\n"
        "    device_lm, kenlm_reader, kenlm_trie, lm, native_beam)\n"
        "assert native_beam._lib is None\n"
        "for name in ('BeamCTCDecoder', 'DeviceBeamDecoder', 'AutoBeamDecoder',\n"
        "             'NgramLM', 'KenLMProbingModel', 'load_lm'):\n"
        "    assert hasattr(d, name), name\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'danspeech_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
