"""Cohort-batched streaming (``MultiStreamTranscriber``) of the PyTorch port
(CPU, float32).

The four cases of ``tests/test_multistream.py``, each held against both the
port's single-stream engine (S independent ``streaming_transcribe``
streams) and the JAX package's ``MultiStreamTranscriber`` on the same
weights and seeded chunks: partials and finals exactly equal.
"""

import numpy as np
import pytest
import torch

from danspeech_tpu.decode.beam import BeamCTCDecoder as JBeam
from danspeech_tpu.models import DeepSpeechModel as JModel
from danspeech_tpu.models import checkpoint as jckpt
from danspeech_tpu.models import deepspeech as jds
from danspeech_tpu.models.config import DeepSpeechConfig as JConfig
from danspeech_tpu.multistream import MultiStreamTranscriber as JMulti
from danspeech_tpu_torch import MultiStreamTranscriber as TMulti
from danspeech_tpu_torch.decode.beam import BeamCTCDecoder as TBeam
from danspeech_tpu_torch.engine import DanSpeechRecognizer as TEngine
from danspeech_tpu_torch.models import DeepSpeechModel as TModel
from danspeech_tpu_torch.models import checkpoint as tckpt
from danspeech_tpu_torch.models.config import DeepSpeechConfig as TConfig

STREAM = dict(model_name="stream", rnn_hidden_size=64, rnn_layers=2,
              conv_layers=2, bidirectional=False, context=20)


def _randomize_bn(sd, seed):
    rng = np.random.default_rng(seed)
    sd = dict(sd)
    for k in list(sd):
        if k.endswith("running_mean"):
            sd[k] = rng.normal(0.0, 0.3, sd[k].shape).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, sd[k].shape).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def models():
    """The same weights in both packages, the head sharpened so that the
    greedy transcripts are not empty: (JAX model, port model)."""
    jcfg, tcfg = JConfig(**STREAM), TConfig(**STREAM)
    params = jds.init_params(jcfg, 11)
    params = {**params, "fc": params["fc"]._replace(weight=params["fc"].weight * 4.0)}
    sd = _randomize_bn(jckpt.state_dict_from_params(params, jcfg), 12)
    return (JModel(jcfg, jckpt.params_from_state_dict(sd, jcfg)),
            TModel(tcfg, tckpt.params_from_state_dict(sd, tcfg)))


def _stream_audio(rng, n_chunks=4, size=15200):
    return [rng.normal(size=size).astype(np.float32) * 600 for _ in range(n_chunks)]


def _streams(seed, n_streams, n_chunks):
    return [_stream_audio(np.random.default_rng(seed + s), n_chunks)
            for s in range(n_streams)]


def _run_single(model, chunks, decoder=None):
    """One stream through the port's single-stream engine."""
    eng = TEngine(model_name=model, device="cpu")
    eng.enable_streaming(secondary_model=None, return_string_parts=True)
    if decoder is not None:
        eng.decoder = decoder
        eng.lm = "beam"  # any non-greedy value puts the engine in LM mode
    outs = [eng.streaming_transcribe(c, is_last=i == len(chunks) - 1, is_first=i == 0)
            for i, c in enumerate(chunks)]
    return outs[:-1], outs[-1]


def _run_cohort(ms, streams):
    n_chunks = len(streams[0])
    parts = [[] for _ in streams]
    final = None
    for ci in range(n_chunks):
        out = ms.step([s[ci] for s in streams], is_last=ci == n_chunks - 1,
                      is_first=ci == 0)
        if ci == n_chunks - 1:
            final = out
        else:
            for s, text in enumerate(out):
                parts[s].append(text)
    return parts, final


@pytest.mark.parametrize("n_streams", [1, 3])
def test_cohort_matches_independent_streams(models, n_streams):
    jm, tm = models
    streams = _streams(7, n_streams, 4)
    got = _run_cohort(TMulti(tm, n_streams=n_streams, device="cpu"), streams)
    assert got == _run_cohort(JMulti(jm, n_streams=n_streams), streams)
    for s in range(n_streams):
        exp_parts, exp_final = _run_single(tm, streams[s])
        assert got[0][s] == exp_parts
        assert got[1][s] == exp_final
    assert any(got[1])  # non-empty finals
    if n_streams > 1:
        assert len(set(got[1])) > 1  # the streams carry different audio


def test_epoch_resets_for_next_cohort(models):
    """After is_last the cohort state resets: replaying the same streams
    gives the same finals."""
    jm, tm = models
    streams = _streams(20, 2, 3)
    ms = TMulti(tm, n_streams=2, device="cpu")
    first = _run_cohort(ms, streams)
    assert ms._state is None and ms.transcripts == ["", ""]
    assert _run_cohort(ms, streams) == first
    assert first == _run_cohort(JMulti(jm, n_streams=2), streams)


def test_lm_final_redecode_matches_single_stream(models):
    """final_decoder: the per-stream re-decode of the concatenated
    probability stream equals the single-stream engine's final output."""
    jm, tm = models
    labels = tm.labels
    tdec = TBeam(labels=labels, lm_path=None, beam_width=8, blank_index=labels.index("_"))
    jdec = JBeam(labels=labels, lm_path=None, beam_width=8, blank_index=labels.index("_"))
    streams = _streams(40, 2, 3)
    singles = [_run_single(tm, streams[s], decoder=tdec)[1] for s in range(2)]
    _, got = _run_cohort(TMulti(tm, n_streams=2, final_decoder=tdec, device="cpu"),
                         streams)
    assert got == singles
    _, ref = _run_cohort(JMulti(jm, n_streams=2, final_decoder=jdec), streams)
    assert got == ref


def test_rejects_ragged_cohort(models):
    _, tm = models
    ms = TMulti(tm, n_streams=2, device="cpu")
    with pytest.raises(ValueError, match="one sample count"):
        ms.step([np.zeros(16000, np.float32), np.zeros(8000, np.float32)],
                is_last=False, is_first=True)
    with pytest.raises(ValueError, match="expected 2 chunks"):
        ms.step([np.zeros(16000, np.float32)], is_last=False, is_first=True)
    with pytest.raises(ValueError):
        TMulti(tm, n_streams=0, device="cpu")


def test_lstm_model_and_missing_gpu_raise(models):
    _, tm = models
    lstm = TModel.init_random(TConfig(**dict(STREAM, rnn_type="lstm", rnn_hidden_size=8)))
    with pytest.raises(NotImplementedError, match="GRU models only"):
        TMulti(lstm, n_streams=2, device="cpu")
    if torch.cuda.is_available():
        ms = TMulti(tm, n_streams=2)
        assert ms.device.type == "cuda" and ms.compute_dtype == "bfloat16"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TMulti(tm, n_streams=2)
    cpu = TMulti(tm, n_streams=2, device="cpu")
    assert cpu.compute_dtype == "float32"
    assert cpu._compute_params["rnns"][0]["fwd"].w_hh.dtype == torch.float32


def test_plain_route_and_bf16_weights_on_the_cpu(models):
    """rnn_impl="plain" equals the default route on the CPU, and the
    bf16 cohort casts the matmul weights once, at construction."""
    _, tm = models
    streams = _streams(60, 2, 3)
    auto = _run_cohort(TMulti(tm, n_streams=2, device="cpu"), streams)
    assert _run_cohort(TMulti(tm, n_streams=2, device="cpu", rnn_impl="plain"),
                       streams) == auto
    bf = TMulti(tm, n_streams=2, device="cpu", compute_dtype="bfloat16")
    assert bf._compute_params["rnns"][0]["fwd"].w_hh.dtype == torch.bfloat16
    parts, finals = _run_cohort(bf, streams)
    assert len(finals) == 2 and all(isinstance(f, str) for f in finals)
