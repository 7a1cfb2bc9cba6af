"""The host plumbing of the PyTorch port: the model and LM zoos over the
md5-validated cache, ``clean_cache``, logging, profiling and the
microphone source (CPU, no network: ``urllib.request.urlopen`` is patched
to raise wherever a download could start).

Zoo files are written by the tests: a ``.pth`` package in the original
layout (``tests/test_checkpoint.py``'s ``make_package``), a ``.dsz``, and a
KenLM trie built from seeded ARPA text under a zoo LM's file name.
"""

import hashlib
import json
import logging
import os
import sys
import urllib.request

import numpy as np
import pytest
import torch

import danspeech_tpu.language_models as jlms
import danspeech_tpu.pretrained_models as jzoo
from danspeech_tpu.audio.microphone import Microphone as JMicrophone
from danspeech_tpu.models.config import DeepSpeechConfig as JConfig
import danspeech_tpu_torch as port
import danspeech_tpu_torch.language_models as tlms
import danspeech_tpu_torch.pretrained_models as tzoo
from danspeech_tpu_torch import Recognizer
from danspeech_tpu_torch.audio import Microphone
from danspeech_tpu_torch.decode.kenlm_trie import write_kenlm_trie
from danspeech_tpu_torch.decode.lm import load_arpa
from danspeech_tpu_torch.models import DeepSpeechModel as TModel
from danspeech_tpu_torch.models.config import DeepSpeechConfig as TConfig
from danspeech_tpu_torch.utils import cache, logging as tlog, profiling

from test_checkpoint import make_package
from test_torch_lm import arpa_text, write_text

SMALL = dict(model_name="zoo-test", rnn_hidden_size=16, rnn_layers=1, conv_layers=1)


def _md5(path):
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


@pytest.fixture
def offline(monkeypatch):
    """Any download attempt fails the test."""
    calls = []

    def refuse(*a, **k):
        calls.append(a)
        raise OSError("the network is not to be touched")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    return calls


def _package(path, seed=0):
    torch.save(make_package(JConfig(**SMALL), seed=seed), str(path))
    return str(path)


def test_zoo_tables_equal_the_jax_package():
    assert tzoo._ZOO == jzoo._ZOO and tzoo._RELEASE == jzoo._RELEASE
    assert tlms._ZOO == jlms._ZOO and tlms._RELEASE == jlms._RELEASE
    assert cache.default_cache_root() == os.path.join(os.path.expanduser("~"),
                                                      ".danspeech_tpu")


def test_a_cached_file_with_a_matching_md5_is_never_downloaded(tmp_path, offline,
                                                              monkeypatch):
    path = _package(tmp_path / "DanSpeechPrimary.pth")
    got = cache.get_model("DanSpeechPrimary.pth", origin="http://x.invalid/a.pth",
                          file_hash=_md5(path), cache_dir=str(tmp_path))
    assert got == path and not offline
    # a zoo constructor over the same cache: no download, the model loads
    filename, _, about = tzoo._ZOO["DanSpeechPrimary"]
    monkeypatch.setitem(tzoo._ZOO, "DanSpeechPrimary", (filename, _md5(path), about))
    model = tzoo.DanSpeechPrimary(cache_dir=str(tmp_path))
    assert not offline
    assert model.config.rnn_hidden_size == SMALL["rnn_hidden_size"]


def test_a_mismatched_md5_leaves_no_partial_file(tmp_path, offline):
    path = _package(tmp_path / "TestModel.pth")
    with pytest.raises(OSError, match="network"):
        cache.get_model("TestModel.pth", origin="http://x.invalid/t.pth",
                        file_hash="0" * 32, cache_dir=str(tmp_path))
    assert len(offline) == 1
    assert not os.path.exists(path)
    assert cache.validate_file(_package(tmp_path / "again.pth"),
                               _md5(tmp_path / "again.pth"))


def test_custom_model_loads_pth_and_dsz(tmp_path):
    pth = _package(tmp_path / "custom.pth", seed=1)
    from_pth = tzoo.CustomModel(pth)
    dsz = str(tmp_path / "custom.dsz")
    from_pth.save(dsz)
    from_dsz = tzoo.CustomModel(dsz)
    assert from_pth.config.to_dict() == from_dsz.config.to_dict()
    for a, b in zip(from_pth.params["rnns"][0]["fwd"], from_dsz.params["rnns"][0]["fwd"]):
        assert torch.equal(a, b)
    assert jzoo.CustomModel(pth).config.to_dict() == from_pth.config.to_dict()


def test_get_model_from_string_resolves_each_entry(monkeypatch, tmp_path):
    """GPUStreamingRNN resolves to its own file (the original registry
    returned CPUStreamingRNN); unknown names give None."""
    pth = _package(tmp_path / "any.pth")
    asked = []

    def fake_get_model(model_name, origin, file_hash=None, cache_dir=None, **kw):
        asked.append((model_name, origin, file_hash))
        return pth

    monkeypatch.setattr(tzoo, "get_model", fake_get_model)
    for name, (filename, md5, _) in tzoo._ZOO.items():
        asked.clear()
        assert isinstance(tzoo.get_model_from_string(name), TModel)
        assert asked == [(filename, f"{tzoo._RELEASE}/{filename}", md5)], name
    asked.clear()
    tzoo.get_model_from_string("GPUStreamingRNN")
    assert asked[0][0] == "GPUStreamingRNN.pth"
    assert tzoo.get_model_from_string("NoSuchModel") is None


def test_a_zoo_lm_under_its_name_serves_through_the_recognizer(tmp_path, offline, monkeypatch):
    labels = TConfig(**SMALL).labels
    words = ["".join(np.random.default_rng(i).choice(list(labels[1:-1]), 4)) for i in range(20)]
    arpa = write_text(str(tmp_path / "lm.arpa"), arpa_text(3, words))
    filename, _ = tlms._ZOO["DSL3gram"]
    klm = str(tmp_path / filename)
    write_kenlm_trie(load_arpa(arpa), klm)
    monkeypatch.setitem(tlms._ZOO, "DSL3gram", (filename, _md5(klm)))
    path = tlms.DSL3gram(cache_dir=str(tmp_path))
    assert path == klm and not offline
    assert tlms.CustomLanguageModel(arpa) == arpa
    model = TModel.init_random(TConfig(**SMALL), seed=2)
    rec = Recognizer(model=model, lm=path, device="cpu")
    assert rec.danspeech_recognizer.lm == path
    wave = (np.random.default_rng(4).normal(size=16000) * 3000).astype(np.int16)
    assert isinstance(rec.recognize(wave), str)
    rec.update_decoder(lm=tlms.CustomLanguageModel(arpa))
    assert isinstance(rec.recognize(wave), str)


def test_clean_cache_under_a_temporary_home(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    root = os.path.join(str(tmp_path), ".danspeech_tpu")
    assert cache.default_cache_root() == root
    os.makedirs(os.path.join(root, "models"))
    with open(os.path.join(root, "models", "x.pth"), "wb") as f:
        f.write(b"0")
    port.clean_cache()
    assert not os.path.exists(root)
    with pytest.warns(cache.NoDefaultCacheDirWarning):
        port.clean_cache()


def test_logger_and_metrics(caplog):
    logger = tlog.get_logger("danspeech_tpu_torch.test")
    assert logging.getLogger("danspeech_tpu_torch").handlers
    with caplog.at_level(logging.INFO, logger="danspeech_tpu_torch"):
        tlog.metrics(logger, "step", loss=1.23456, n=3)
        with tlog.Timed(logger, "stage", k="v"):
            pass
    lines = [r.getMessage() for r in caplog.records]
    assert "step loss=1.235 n=3" in lines
    assert any(m.startswith("stage seconds=") and m.endswith("k=v") for m in lines)


def test_device_trace_writes_a_trace_and_amortized_seconds(tmp_path):
    def work(x):
        with profiling.annotate("matmul_block"):
            return x @ x

    x = torch.randn(32, 32)
    with profiling.device_trace(str(tmp_path / "trace")):
        work(x)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0], encoding="utf-8") as f:
        trace = json.load(f)
    assert any(e.get("name") == "matmul_block" for e in trace["traceEvents"])
    s = profiling.amortized_seconds(work, x, iters=3)
    assert 0 < s < 10
    assert profiling.amortized_seconds(lambda: {"a": [1, (x,)]}, iters=2) >= 0


def test_microphone_without_pyaudio_raises_the_jax_message(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyaudio", None)  # import pyaudio fails
    with pytest.raises(AttributeError) as got:
        Microphone()
    with pytest.raises(AttributeError) as ref:
        JMicrophone()
    assert str(got.value) == str(ref.value)
    assert "PyAudio" in str(got.value)
    with pytest.raises(AttributeError):
        Microphone.list_microphone_names()
