"""Two of the gallery's twins against the JAX scripts of ``examples/`` (CPU).

``batch_serving`` and ``device_beam_and_long_form`` run at their own demo
models (the same seeds give the same weights in both packages) over the
inputs of ``tests/test_torch_examples.py``; each JAX script's ``main()``
runs in-process (loaded with importlib, ``sys.argv`` patched, its stdout
read). The transcripts both print must be equal, float32 on the CPU. Kept
apart from the port-only checks so that the suite's workers share the
load.
"""

import importlib.util
import os
import sys

import pytest

from danspeech_tpu_torch.examples import batch_serving, device_beam_and_long_form

from test_torch_examples import CPU, offline, one_thread, write_inputs  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_inputs(tmp_path_factory.mktemp("gallery_jax"))


def jax_script(name, argv, monkeypatch, capsys):
    """Run ``examples/<name>.py``'s main() in-process; its stdout lines."""
    spec = importlib.util.spec_from_file_location(f"jax_gallery_{name}",
                                                  os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out.splitlines()


def test_batch_serving_equals_the_jax_script(data, monkeypatch, capsys):
    """The demo model (5x400, seed 0) in both packages, float32 on the CPU:
    every clip's printed transcript is equal."""
    ref = jax_script("batch_serving", ["--wav-dir", data["wavs"]], monkeypatch, capsys)
    out = batch_serving.main(["--wav-dir", data["wavs"], *CPU])
    got = capsys.readouterr().out.splitlines()
    rows = [line for line in ref if line.startswith("  u")]
    assert len(rows) == 4 and rows == [line for line in got if line.startswith("  u")]
    assert [r.split(": ", 1)[1] for r in rows] == [t[:60] for t in out["texts"]]


def test_device_beam_and_long_form_equals_the_jax_script(data, monkeypatch, capsys):
    """The demo model (2x96, seed 3) and the demo bigram in both packages:
    the host, device and sharded beams and the long form print alike (the
    JAX mesh is 8 CPU devices, the port's this process alone)."""
    ref = jax_script("device_beam_and_long_form", ["--wav", data["one"]], monkeypatch,
                     capsys)
    device_beam_and_long_form.main(["--wav", data["one"], *CPU])
    got = capsys.readouterr().out.splitlines()
    heads = ("host C++ beam:", "on-device LM beam:", "mesh-sharded beam:",
             "long-form (greedy):")
    ref = [line for line in ref if line.startswith(heads)]
    assert len(ref) == 4 and ref == [line for line in got if line.startswith(heads)]
