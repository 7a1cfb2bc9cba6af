"""Serving with a language model through the port's engine and API,
against the JAX package's (CPU, float32).

A small bidirectional model and a small streaming model, the same weights
on both sides through the state-dict bridge; the head is biased towards
space and blank so that the transcripts hold words. The LM is an ARPA text
written by the test over words of the greedy transcripts (and their
prefixes, so that the LM has choices to make). ``recognize``,
``recognize_batch`` and their ``show_all`` beam lists must equal the JAX
``Recognizer``'s for ``backend="host"``, ``"device"`` and ``"auto"``; the
streaming final re-decode must equal the JAX engine's.
"""

import os
import warnings

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from danspeech_tpu.engine import DanSpeechRecognizer as JEngine
from danspeech_tpu.models import DeepSpeechModel as JModel
from danspeech_tpu.models import checkpoint as jckpt
from danspeech_tpu.models import deepspeech as jds
from danspeech_tpu.models.config import DeepSpeechConfig as JConfig
from danspeech_tpu.recognizer import Recognizer as JRecognizer
from danspeech_tpu_torch import Recognizer as TRecognizer
from danspeech_tpu_torch.audio import load_audio
from danspeech_tpu_torch.decode import beam_auto
from danspeech_tpu_torch.decode.beam import BeamCTCDecoder
from danspeech_tpu_torch.decode.beam_auto import AutoBeamDecoder
from danspeech_tpu_torch.decode.device_beam import DeviceBeamDecoder
from danspeech_tpu_torch.decode.kenlm_reader import write_kenlm_probing
from danspeech_tpu_torch.decode.lm import load_arpa
from danspeech_tpu_torch.engine import DanSpeechRecognizer as TEngine
from danspeech_tpu_torch.engine import NoLmInstantiatedWarning
from danspeech_tpu_torch.models import DeepSpeechModel as TModel
from danspeech_tpu_torch.models import checkpoint as tckpt
from danspeech_tpu_torch.models.config import DeepSpeechConfig as TConfig
from test_torch_lm import arpa_text, write_text

DATA = os.path.join(os.path.dirname(__file__), "data")
BATCH = dict(model_name="lm-small", rnn_hidden_size=32, rnn_layers=2, conv_layers=3)
STREAM = dict(model_name="lm-stream", rnn_hidden_size=64, rnn_layers=2,
              conv_layers=2, bidirectional=False, context=20)
ALPHA, BETA, W = 1.0, 0.3, 16


def boosted_pair(cfg, seed, space=0.4, blank=0.3, sharpen=1.0):
    """The same weights in both packages, with the head's first feature made
    a constant 1 that feeds only the space and blank logits."""
    jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
    params = jds.init_params(jcfg, seed)
    params = {**params, "fc": params["fc"]._replace(weight=params["fc"].weight * sharpen)}
    sd = dict(jckpt.state_dict_from_params(params, jcfg))
    bias = sd["fc.0.module.0.bias"].copy()
    bias[0] = 1.0
    weight = sd["fc.0.module.1.weight"].copy()
    weight[:, 0] = 0.0
    weight[tcfg.labels.index(" "), 0] = space
    weight[tcfg.labels.index("_"), 0] = blank
    sd["fc.0.module.0.bias"], sd["fc.0.module.1.weight"] = bias, weight
    return (JModel(jcfg, jckpt.params_from_state_dict(sd, jcfg)),
            TModel(tcfg, tckpt.params_from_state_dict(sd, tcfg)))


def recordings():
    clips = [load_audio(os.path.join(DATA, f))
             for f in ("clip_mono.wav", "clip_stereo.wav", "clip_mono.flac")]
    rng = np.random.default_rng(1)
    return clips + [rng.normal(size=n) * 2000.0 for n in (16000, 24000, 5000, 40000)]


def lm_over(texts, tmp, seed):
    """An ARPA LM over the words of ``texts`` and their prefixes."""
    words = sorted({w for t in texts for w in t.split()}
                   | {w[:-1] for t in texts for w in t.split() if len(w) > 2})
    return write_text(os.path.join(tmp, "lm.arpa"), arpa_text(seed, words))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    jm, tm = boosted_pair(BATCH, 3)
    recs = recordings()
    greedy = JRecognizer(model=jm, compute_dtype="float32").recognize_batch(recs)
    arpa = lm_over(greedy, str(tmp_path_factory.mktemp("lm_engine")), 6)
    jrec = JRecognizer(model=jm, lm=arpa, alpha=ALPHA, beta=BETA,
                       compute_dtype="float32", beam_width=W)
    trec = TRecognizer(model=tm, lm=arpa, alpha=ALPHA, beta=BETA, device="cpu",
                       beam_width=W)
    return dict(jrec=jrec, trec=trec, jm=jm, tm=tm, recs=recs, greedy=greedy,
                arpa=arpa)


@pytest.mark.parametrize("backend", ["host", "device", "auto"])
def test_recognize_batch_and_show_all_equal_jax(served, backend):
    jrec, trec, recs = served["jrec"], served["trec"], served["recs"]
    jrec.update_decoder(backend=backend)
    trec.update_decoder(backend=backend)
    if backend == "auto":
        # a crossover of 2: the groups of two rows and more take the device
        # beam, the one-row calls the host beam, in both packages
        jrec.danspeech_recognizer.decoder.crossover = 2
        trec.danspeech_recognizer.decoder.crossover = 2
    teng = trec.danspeech_recognizer
    assert type(teng.decoder).__name__ == type(jrec.danspeech_recognizer.decoder).__name__
    assert teng.decoder_backend == backend
    top = trec.recognize_batch(recs)
    assert top == jrec.recognize_batch(recs)
    beams = trec.recognize_batch(recs, show_all=True)
    assert beams == jrec.recognize_batch(recs, show_all=True)
    assert [b[0] for b in beams] == top and all(len(b) > 1 for b in beams)
    one = trec.recognize(recs[1], show_all=True)
    assert one == jrec.recognize(recs[1], show_all=True)
    assert trec.recognize(recs[0]) == jrec.recognize(recs[0])
    # the LM made decisions: some transcript differs from the greedy one
    assert top != served["greedy"]
    if backend == "auto":  # one group of 4 rows on the device beam, 1-row calls on the host
        assert isinstance(teng.decoder._device, DeviceBeamDecoder)
        assert isinstance(teng.decoder._host, BeamCTCDecoder)


def test_show_all_warns_only_when_greedy(served):
    trec, recs = served["trec"], served["recs"]
    with warnings.catch_warnings():
        warnings.simplefilter("error", NoLmInstantiatedWarning)
        trec.recognize(recs[0], show_all=True)
    greedy = TRecognizer(model=served["tm"], device="cpu")
    with pytest.warns(NoLmInstantiatedWarning):
        assert greedy.recognize(recs[0], show_all=True) == [served["greedy"][0]]


def _engines(served):
    jeng = JEngine(compute_dtype="float32")
    jeng.update_model(served["jm"])
    teng = TEngine(device="cpu")
    teng.update_model(served["tm"])
    return jeng, teng


def test_update_decoder_change_detection_equals_jax(served):
    """The same sequence of calls rebuilds the decoder at the same calls in
    both packages, into decoders of the same kind and settings: None keeps a
    value, 0.0 is a real value, an unchanged call rebuilds nothing."""
    jeng, teng = _engines(served)
    arpa = served["arpa"]
    calls = [
        dict(), dict(lm=arpa), dict(lm=arpa), dict(alpha=0.0), dict(alpha=None),
        dict(beta=0.0), dict(beta=0.0), dict(beam_width=8), dict(backend="host"),
        dict(backend="host"), dict(backend="device"), dict(alpha=2.0, backend="auto"),
        dict(lm="greedy"), dict(lm="greedy"), dict(lm=arpa, beam_width=8),
    ]
    for kw in calls:
        jprev, tprev = jeng.decoder, teng.decoder
        jeng.update_decoder(**kw)
        teng.update_decoder(**kw)
        assert (jeng.decoder is jprev) == (teng.decoder is tprev), kw
        assert type(jeng.decoder).__name__ == type(teng.decoder).__name__, kw
        for attr in ("lm", "alpha", "beta", "beam_width", "decoder_backend"):
            assert getattr(jeng, attr) == getattr(teng, attr), (kw, attr)
    assert isinstance(teng.decoder, AutoBeamDecoder)
    assert (teng.decoder.alpha, teng.decoder.beam_width) == (2.0, 8)
    with pytest.raises(ValueError, match="unknown decoder backend"):
        teng.update_decoder(backend="gpu")


def test_auto_router_and_refusals(served, tmp_path, monkeypatch):
    teng = _engines(served)[1]
    monkeypatch.setenv("DANSPEECH_TPU_BEAM_CROSSOVER", "3")
    teng.update_decoder(lm=served["arpa"], backend="auto")
    assert teng.decoder.crossover == 3  # the JAX package's override
    monkeypatch.delenv("DANSPEECH_TPU_BEAM_CROSSOVER")
    teng.update_decoder(lm="greedy")
    teng.update_decoder(lm=served["arpa"], backend="auto")
    dec = teng.decoder
    assert isinstance(dec, AutoBeamDecoder)
    assert dec.crossover == beam_auto.DEFAULT_CROSSOVER
    assert dec.device_lm.device.type == "cpu"
    assert isinstance(dec.for_batch(1), BeamCTCDecoder)
    assert isinstance(dec.for_batch(dec.crossover - 1), BeamCTCDecoder)
    assert isinstance(dec.for_batch(dec.crossover), DeviceBeamDecoder)
    assert isinstance(dec.for_batch(128), DeviceBeamDecoder)
    assert dec.for_batch(1)._native is not None  # the C++ route
    assert dec._device.device.type == "cpu"
    # a probing .klm cannot be packed for the device: auto pins the host
    klm = str(tmp_path / "p.klm")
    write_kenlm_probing(load_arpa(served["arpa"]), klm)
    teng.update_decoder(lm=klm)
    assert isinstance(teng.decoder, BeamCTCDecoder)
    with pytest.raises(ValueError, match="backend='host'"):
        teng.update_decoder(backend="device")
    # the sharded beam needs a mesh, and the device tables the .klm lacks
    with pytest.raises(ValueError, match="needs a mesh"):
        teng.update_decoder(backend="sharded")
    mesh = SimpleNamespace(size=lambda axis: 1, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="backend='host'"):
        teng.update_decoder(mesh=mesh)


def test_standalone_auto_decode_routes_by_batch(served):
    labels = served["tm"].labels
    lm = load_arpa(served["arpa"])
    from danspeech_tpu_torch.decode.lm import coerce_device_lm

    dec = AutoBeamDecoder(labels=labels, lm=lm,
                          device_lm=coerce_device_lm(lm, labels, device="cpu"),
                          alpha=ALPHA, beta=BETA, beam_width=8,
                          blank_index=labels.index("_"), crossover=2, device="cpu")
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 40, len(labels))).astype(np.float32)
    logits[:, :, 0] += 2.0
    e = np.exp(logits - logits.max(-1, keepdims=True))
    probs = e / e.sum(-1, keepdims=True)
    sizes = np.array([40, 33, 40])
    batch, _ = dec.decode(torch.from_numpy(probs), sizes, n_best=1)  # device
    singles = [dec.decode(torch.from_numpy(probs[i : i + 1]), sizes[i : i + 1])[0][0]
               for i in range(3)]  # host
    assert dec._device is not None and dec._host is not None
    assert [b[0] for b in batch] == [s[0] for s in singles]


def _stream_chunks(seed, n=6, size=15200, tail=100):
    rng = np.random.default_rng(seed)
    chunks = [rng.normal(size=size).astype(np.float32) * 600 for _ in range(n)]
    return chunks + [rng.normal(size=tail).astype(np.float32) * 600]


def _run_stream(eng, chunks):
    eng.enable_streaming(secondary_model=None, return_string_parts=True)
    return [eng.streaming_transcribe(c, is_last=i == len(chunks) - 1, is_first=i == 0)
            for i, c in enumerate(chunks)]


@pytest.mark.parametrize("backend", ["host", "device"])
def test_streaming_final_lm_redecode_equals_jax(tmp_path, backend):
    jm, tm = boosted_pair(STREAM, 11, sharpen=4.0)
    chunks = _stream_chunks(5)
    jeng = JEngine(model_name=jm, compute_dtype="float32")
    teng = TEngine(model_name=tm, device="cpu")
    greedy = _run_stream(teng, chunks)
    assert greedy == _run_stream(jeng, chunks)
    arpa = lm_over(["".join(greedy[1:-1])], str(tmp_path), 9)
    for eng in (jeng, teng):
        eng.update_decoder(lm=arpa, alpha=ALPHA, beta=BETA, beam_width=W, backend=backend)
    ref = _run_stream(jeng, chunks)
    got = _run_stream(teng, chunks)
    assert got == ref
    assert got[:-1] == greedy[:-1]  # the partials stay greedy
    assert got[-1] != greedy[-1]  # the final is the LM re-decode
    # the final equals a decode of the kept probabilities, and the reset
    # cleared them for the next stream
    teng.enable_streaming(secondary_model=None, return_string_parts=True)
    for i, c in enumerate(chunks[:-1]):
        teng.streaming_transcribe(c, is_last=False, is_first=i == 0)
    kept = np.concatenate(teng.full_output, axis=1)
    assert kept.shape[0] == 1 and kept.shape[2] == len(tm.labels)
    assert teng.streaming_transcribe(chunks[-1], is_last=True, is_first=False) == got[-1]
    assert teng.full_output == []
    direct, _ = teng.decoder.decode(kept, np.array([kept.shape[1]]))
    assert direct[0][0] == got[-1]
    teng.enable_streaming()
    teng.streaming_transcribe(chunks[0], is_last=False, is_first=True)
    teng.streaming_transcribe(chunks[1], is_last=False, is_first=False)
    assert teng.full_output
    teng.reset_streaming_params()
    assert teng.full_output == []
