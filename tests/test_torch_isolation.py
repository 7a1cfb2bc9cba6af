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
        "'language_models', 'models.torch_pickle', 'parallel.mesh', "
        "'parallel.sharding', 'parallel.batch', 'parallel.time_shard', "
        "'parallel.tp', 'parallel.pipeline', 'decode.dist_beam'):\n"
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
    for module in ("mesh.py", "sharding.py", "batch.py", "time_shard.py", "tp.py",
                   "pipeline.py"):
        assert any(p.endswith(os.path.join("parallel", module)) for p in sources), module
    assert any(p.endswith(os.path.join("decode", "dist_beam.py")) for p in sources)
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
    """Each of the nine wrappers has its plain version beside it, a
    ``launches`` counter and ``dtype_counts`` by operand set; the CUDA
    sources they name exist (the bf16 kernel and the float32 variant: B1-B4
    in csrc/gru_f32.cu, B5-B7 in csrc/lstm_f32.cu, B8-B9 in
    csrc/rnn_tanh_f32.cu); the lookahead stencil (float32 only,
    csrc/lookahead.cu) has the same; and no source lies under csrc/ without
    a wrapper."""
    from danspeech_tpu_torch.ops import (cuda_build, gru_cuda, lookahead_cuda, lstm_cuda,
                                         rnn_tanh_cuda)

    kernels = {
        gru_cuda: {"gru_bidi_fused": "gru_bidi_fused", "gru_scan": "gru_scan",
                   "gru_scan_bidi": "gru_scan_bidi", "gru_bwd_scan": "gru_bwd"},
        lstm_cuda: {"lstm_scan": "lstm_scan", "lstm_scan_with_cell": "lstm_scan",
                    "lstm_bwd_scan": "lstm_bwd"},
        rnn_tanh_cuda: {"rnn_tanh_scan": "rnn_tanh_scan",
                        "rnn_tanh_bwd_scan": "rnn_tanh_bwd"},
    }
    float32_sources = {gru_cuda: "gru_f32", lstm_cuda: "lstm_f32",
                       rnn_tanh_cuda: "rnn_tanh_f32"}
    sources = set()
    for module, names in kernels.items():
        for name, source in names.items():
            assert callable(getattr(module, f"{name}_plain")), name
            assert isinstance(getattr(module, name).launches, int), name
            assert set(getattr(module, name).dtype_counts) == {"bfloat16", "float32"}, name
            for src in (source, float32_sources[module]):
                assert os.path.isfile(os.path.join(cuda_build.CSRC_DIR, f"{src}.cu")), src
                sources.add(f"{src}.cu")
    assert callable(lookahead_cuda.lookahead_plain)
    assert isinstance(lookahead_cuda.lookahead.launches, int)
    assert set(lookahead_cuda.lookahead.dtype_counts) == {"float32"}
    assert os.path.isfile(os.path.join(cuda_build.CSRC_DIR, "lookahead.cu"))
    sources.add("lookahead.cu")
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


def test_parallel_entry_points_default_to_cuda():
    """make_mesh() and initialize_multihost default to CUDA (NCCL): without a
    GPU they raise and build no group, rather than a CPU group; a CPU group
    is made only when device="cpu" is passed. A CUDA mesh over a gloo group
    that the caller did not ask for by backend= raises. The pipeline's
    devices default to the CUDA cards. Run in a fresh process: a group lives
    per process."""
    code = (
        "import torch, torch.distributed as dist\n"
        "from danspeech_tpu_torch.parallel import (PipelinedTranscriber, "
        "initialize_multihost, make_mesh)\n"
        "from danspeech_tpu_torch.models import DeepSpeechModel, DeepSpeechConfig\n"
        "assert not torch.cuda.is_available()\n"
        "for call in (make_mesh, lambda: initialize_multihost('127.0.0.1:1', 1, 0)):\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('no error without a GPU')\n"
        "    assert not dist.is_initialized()\n"
        "try:\n"
        "    make_mesh(device='cpu', backend='nccl')\n"
        "except ValueError as e:\n"
        "    assert 'needs a CUDA device' in str(e), e\n"
        "assert not dist.is_initialized()\n"
        "m = DeepSpeechModel.init_random(DeepSpeechConfig(rnn_hidden_size=8, "
        "rnn_layers=1, conv_layers=1))\n"
        "try:\n"
        "    PipelinedTranscriber(m)\n"
        "except RuntimeError as e:\n"
        "    assert 'no CUDA device' in str(e), e\n"
        "mesh = make_mesh(device='cpu')\n"
        "assert (mesh.backend, mesh.world_size, mesh.transport) == ('gloo', 1, 'gloo')\n"
        "import danspeech_tpu_torch.parallel.mesh as pm\n"
        "pm._pick_device = lambda d: torch.device('cuda', 0)  # as on a card\n"
        "torch.cuda.set_device = lambda d: None\n"
        "try:\n"
        "    make_mesh()\n"
        "except ValueError as e:\n"
        "    assert 'runs gloo, not the nccl' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('a CUDA mesh took the gloo group without backend=')\n"
        "print('ok')\n"
    )
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_gallery_imports_no_jax():
    """The gallery's twins import neither JAX nor anything of
    danspeech_tpu, and importing them starts no process."""
    code = (
        "import importlib, subprocess, sys\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a process was started at import')\n"
        "subprocess.run = subprocess.Popen = subprocess.call = refuse\n"
        "from danspeech_tpu_torch import examples\n"
        "assert len(examples.TWINS) == 8\n"
        "for name in examples.TWINS:\n"
        "    m = importlib.import_module('danspeech_tpu_torch.examples.' + name)\n"
        "    assert callable(m.main), name\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'danspeech_tpu', 'pyaudio')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("name", [
    "batch_serving", "device_beam_and_long_form", "multi_stream_server",
    "real_time_streaming_example", "run_recognize", "stream_example", "train_finetune",
    "video_transcribe_simulation"])
def test_gallery_twin_defaults_to_cuda(name):
    """Every twin resolves ``--device`` before it reads anything: without
    ``--device cpu`` and without a GPU it raises at once."""
    import argparse
    import importlib

    from danspeech_tpu_torch import examples

    module = importlib.import_module(f"danspeech_tpu_torch.examples.{name}")
    argv = {"train_finetune": ["train.csv"],
            "video_transcribe_simulation": ["long.wav"]}.get(name, [])
    if torch.cuda.is_available():
        ap = argparse.ArgumentParser()
        examples.add_device(ap)
        assert examples.parse(ap, []).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main(argv)
