"""Isolation of the PyTorch port: it imports neither JAX nor anything of
``danspeech_tpu``, and its entry points run on CUDA unless told otherwise."""

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
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'danspeech_tpu')]\n"
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
