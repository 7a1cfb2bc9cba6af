"""Batch transcription of the PyTorch port against the JAX package (CPU).

Greedy transcripts must be exactly equal to the JAX engine's in float32,
over the ``tests/data`` clips and seeded waveforms (int16 and float). The
dispatch plan must be identical.
"""

import os

import numpy as np
import pytest
import torch

from danspeech_tpu.engine import DanSpeechRecognizer as JRecognizerEngine
from danspeech_tpu.models import DeepSpeechModel as JModel
from danspeech_tpu.models.config import DeepSpeechConfig as JConfig
from danspeech_tpu.recognizer import Recognizer as JRecognizer
from danspeech_tpu_torch import Recognizer as TRecognizer
from danspeech_tpu_torch.audio import load_audio, load_audio_pcm16
from danspeech_tpu_torch.engine import DanSpeechRecognizer as TRecognizerEngine
from danspeech_tpu_torch.models import DeepSpeechModel as TModel
from danspeech_tpu_torch.models.config import DeepSpeechConfig as TConfig

DATA = os.path.join(os.path.dirname(__file__), "data")
CFG = dict(model_name="small", rnn_hidden_size=32, rnn_layers=2, conv_layers=3)


@pytest.fixture(scope="module")
def engines():
    jeng = JRecognizerEngine(compute_dtype="float32")
    jeng.update_model(JModel.init_random(JConfig(**CFG), seed=3))
    teng = TRecognizerEngine(device="cpu")
    teng.update_model(TModel.init_random(TConfig(**CFG), seed=3))
    return jeng, teng


def _recordings():
    clips = [load_audio(os.path.join(DATA, f)) for f in ("clip_mono.wav", "clip_stereo.wav")]
    clips.append(load_audio_pcm16(os.path.join(DATA, "clip_mono.wav")))
    rng = np.random.default_rng(0)
    ints = [np.clip(rng.normal(size=n) * 3000, -32768, 32767).astype(np.int16)
            for n in (16000, 30000, 9000, 47000, 170, 100)]
    floats = [rng.normal(size=n) * 1500.0 for n in (20000, 5000)]
    return clips + ints + floats


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plan_groups_identical(engines, seed):
    jeng, teng = engines
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    recs = [np.zeros(int(k), np.int16) for k in rng.integers(100, 200000, size=n)]
    assert teng._plan_groups(recs) == jeng._plan_groups(recs)


def test_transcribe_batch_equals_jax(engines):
    jeng, teng = engines
    recs = _recordings()
    ref = jeng.transcribe_batch(recs)
    got = teng.transcribe_batch(recs)
    assert got == ref
    assert teng.transcribe_batch(recs, show_all=True) == [[s] for s in ref]


def test_int16_batches_equal_jax(engines):
    """All-int16 dispatch groups stage as int16 on both sides."""
    jeng, teng = engines
    recs = [r for r in _recordings() if r.dtype == np.int16]
    buf, lengths = teng._stage_group(recs, list(range(len(recs))), 48000)
    assert buf.dtype == torch.int16 and buf.shape == (8, 48000)
    np.testing.assert_array_equal(lengths[: len(recs)], [len(r) for r in recs])
    assert teng.transcribe_batch(recs) == jeng.transcribe_batch(recs)


def test_recognizer_recognize_equals_jax():
    wave = load_audio(os.path.join(DATA, "clip_stereo.wav"))
    jrec = JRecognizer(model=JModel.init_random(JConfig(**CFG), seed=4),
                       compute_dtype="float32")
    trec = TRecognizer(model=TModel.init_random(TConfig(**CFG), seed=4), device="cpu")
    assert trec.recognize(wave) == jrec.recognize(wave)
    assert trec.recognize_batch([wave, wave[:8000]]) == jrec.recognize_batch(
        [wave, wave[:8000]]
    )


def test_unported_options_raise(engines):
    """backend="sharded" and mesh= are taken as the JAX engine takes them:
    with no LM the decoder stays greedy, and the mesh is remembered for the
    sharded beam. Unknown options raise."""
    jeng, teng = engines
    mesh = object()
    for kw in (dict(backend="sharded"), dict(mesh=mesh)):
        jeng.update_decoder(**kw)
        teng.update_decoder(**kw)
        assert type(teng.decoder).__name__ == type(jeng.decoder).__name__ == "GreedyDecoder"
    assert teng.decoder_backend == jeng.decoder_backend == "sharded"
    assert teng.decoder_mesh is mesh and jeng.decoder_mesh is mesh
    for eng in engines:  # as the other tests of the module expect them
        eng.update_decoder(backend="auto")
    with pytest.raises(ValueError):
        TRecognizerEngine(device="cpu", transfer_format="alaw")
    with pytest.raises(ValueError):
        TRecognizerEngine(device="cpu", compute_dtype="float16")
