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
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'danspeech_tpu')]\n"
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
