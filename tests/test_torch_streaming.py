"""Real-time streaming and the unidirectional GRU models of the PyTorch port
against the JAX package (CPU).

Small models (2 conv, 2x64 unidirectional GRU, lookahead context 20, BN
statistics randomised, the head sharpened so greedy partials are not
empty), the same weights on both sides through the state-dict bridge, in
float32 unless a test says otherwise. Tolerances: chunk probabilities
within PROB_ATOL and carried state within STATE_ATOL (summation order
only); transcripts, partials and finals exactly equal. In bf16 the port's
convolutions round their outputs to bf16 where JAX's keep f32 (ROADMAP C5),
so a bf16 forward is held to BF16_ATOL.
"""

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from danspeech_tpu.engine import DanSpeechRecognizer as JEngine
from danspeech_tpu.audio.io import SpeechSource as JSpeechSource
from danspeech_tpu.errors import NoDataInBuffer as JNoDataInBuffer
from danspeech_tpu.features.spectrogram import (
    InferenceSpectrogramAudioParser as JParser,
)
from danspeech_tpu.models import DeepSpeechModel as JModel
from danspeech_tpu.models import checkpoint as jckpt
from danspeech_tpu.models import deepspeech as jds
from danspeech_tpu.models import streaming as jst
from danspeech_tpu.models.config import DeepSpeechConfig as JConfig
from danspeech_tpu.recognizer import Recognizer as JRecognizer
from danspeech_tpu_torch import Recognizer as TRecognizer
from danspeech_tpu_torch.audio.io import SpeechSource as TSpeechSource
from danspeech_tpu_torch.audio.io import _PCMStream
from danspeech_tpu_torch.engine import DanSpeechRecognizer as TEngine
from danspeech_tpu_torch.engine import _resolve_compute_dtype
from danspeech_tpu_torch.errors import ConvError, NoDataInBuffer, WrongUsageOfListen
from danspeech_tpu_torch.features.spectrogram import (
    InferenceSpectrogramAudioParser as TParser,
)
from danspeech_tpu_torch.models import DeepSpeechModel as TModel
from danspeech_tpu_torch.models import checkpoint as tckpt
from danspeech_tpu_torch.models import deepspeech as tds
from danspeech_tpu_torch.models import streaming as tst
from danspeech_tpu_torch.models.config import DeepSpeechConfig as TConfig

PROB_ATOL = 1e-4
STATE_ATOL = 1e-4
BF16_ATOL = 1e-2

STREAM = dict(model_name="stream", rnn_hidden_size=64, rnn_layers=2,
              conv_layers=2, bidirectional=False, context=20)
SECONDARY = dict(model_name="secondary", rnn_hidden_size=64, rnn_layers=2,
                 conv_layers=2)


def _randomize_bn(sd, seed):
    rng = np.random.default_rng(seed)
    sd = dict(sd)
    for k in list(sd):
        if k.endswith("running_mean"):
            sd[k] = rng.normal(0.0, 0.3, sd[k].shape).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, sd[k].shape).astype(np.float32)
    return sd


def _pair(cfg, seed, sharpen=1.0):
    """The same weights in both packages: (JAX model, port model)."""
    jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
    params = jds.init_params(jcfg, seed)
    params = {**params, "fc": params["fc"]._replace(weight=params["fc"].weight * sharpen)}
    sd = _randomize_bn(jckpt.state_dict_from_params(params, jcfg), seed + 1)
    return (JModel(jcfg, jckpt.params_from_state_dict(sd, jcfg)),
            TModel(tcfg, tckpt.params_from_state_dict(sd, tcfg)))


@pytest.fixture(scope="module")
def stream_models():
    return _pair(STREAM, 11, sharpen=4.0)


@pytest.fixture(scope="module")
def secondary_models():
    return _pair(SECONDARY, 5)


def _chunks(seed, n=6, size=15200, tail=None):
    rng = np.random.default_rng(seed)
    chunks = [rng.normal(size=size).astype(np.float32) * 600 for _ in range(n)]
    if tail is not None:
        chunks.append(rng.normal(size=tail).astype(np.float32) * 600)
    return chunks


def test_streaming_parser_equals_jax():
    """Rolling buffer, hop remainder, held short chunk, NST normalisation
    ramp and the short final drop, chunk by chunk."""
    rng = np.random.default_rng(0)
    sizes = [6240, 8640, 200, 3201, 16000, 15999, 100, 400]
    jp, tp = JParser(), TParser()
    for i, n in enumerate(sizes):
        chunk = rng.normal(size=n).astype(np.float32) * 800
        last = i == len(sizes) - 1
        ref = jp.parse_audio(chunk, last)
        got = tp.parse_audio(chunk, last)
        assert len(got) == len(ref)
        if len(ref):
            np.testing.assert_array_equal(got, np.asarray(ref))
        assert (tp.alpha, tp.input_mean, tp.input_std) == (
            jp.alpha, jp.input_mean, jp.input_std)


def _spects(chunks):
    parser = TParser()
    out = []
    for i, c in enumerate(chunks):
        s = parser.parse_audio(c, i == len(chunks) - 1)
        if len(s):
            out.append(np.asarray(s, np.float32))
    return out


def _assert_state_close(got, ref):
    for g, r in zip(got.hiddens, ref.hiddens):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=STATE_ATOL, rtol=0)
    for name in ("left_1", "left_2", "la_buffer"):
        g, r = getattr(got, name), getattr(ref, name)
        assert (g is None) == (r is None), name
        if r is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=STATE_ATOL,
                                       rtol=0, err_msg=name)


def test_streaming_step_exact_matches_jax(stream_models):
    jm, tm = stream_models
    spects = _spects(_chunks(1, n=4, tail=3000))
    jstate = jst.init_stream_state(jm.config)
    tstate = tst.init_stream_state(tm.config)
    for i, s in enumerate(spects):
        first, last = i == 0, i == len(spects) - 1
        ref, jstate = jst.streaming_step(jm.params, jm.config, jnp.asarray(s)[None, None],
                                         jstate, first, last)
        got, tstate = tst.streaming_step(tm.params, tm.config,
                                         torch.from_numpy(s)[None, None],
                                         tstate, first, last)
        assert (got is None) == (ref is None)
        if ref is not None:
            assert tuple(got.shape) == ref.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=PROB_ATOL, rtol=0)
        _assert_state_close(tstate, jstate)


def _padded(s, bucket=16):
    t = s.shape[1]
    tp = max(bucket, -(-(t + tst.CHUNK_HEADROOM) // bucket) * bucket)
    x = np.zeros((s.shape[0], tp), np.float32)
    x[:, :t] = s
    return x, t


def test_streaming_step_masked_matches_jax(stream_models):
    jm, tm = stream_models
    # a short middle chunk shrinks the lookahead buffer below context - 1
    spects = _spects(_chunks(2, n=3) + _chunks(3, n=1, size=1200) + _chunks(4, n=2))
    x0, _ = _padded(spects[0])
    cap = -(-tst.phys_rnn_frames(x0.shape[1], True) // 16) * 16
    assert cap == -(-jst.phys_rnn_frames(x0.shape[1], True) // 16) * 16
    jstate = jst.init_stream_state_masked(jm.config, buf_cap=cap)
    tstate = tst.init_stream_state_masked(tm.config, buf_cap=cap)
    for i, s in enumerate(spects):
        first, last = i == 0, i == len(spects) - 1
        x, t = _padded(s)
        ref, ref_len, jstate = jst.streaming_step_masked(
            jm.params, jm.config, jnp.asarray(x)[None, None], t, jstate, first, last)
        got, got_len, tstate = tst.streaming_step_masked(
            tm.params, tm.config, torch.from_numpy(x)[None, None], t, tstate,
            first, last)
        assert got_len == int(ref_len)
        assert tstate.buf_len == int(jstate.buf_len)
        assert (got is None) == (ref is None)
        if ref is not None:
            np.testing.assert_allclose(got.numpy()[:, :got_len],
                                       np.asarray(ref)[:, :got_len],
                                       atol=PROB_ATOL, rtol=0)
        _assert_state_close(tstate, jstate)


def test_streaming_requires_two_convs():
    tm = TModel.init_random(TConfig(**dict(STREAM, conv_layers=3)), seed=0)
    state = tst.init_stream_state_masked(tm.config, buf_cap=32)
    with pytest.raises(ConvError):
        tst.streaming_step_masked(tm.params, tm.config, torch.zeros(1, 1, 161, 32),
                                  20, state, True, False)


def _run_stream(eng, chunks, **enable):
    eng.enable_streaming(**enable)
    return [eng.streaming_transcribe(c, is_last=i == len(chunks) - 1, is_first=i == 0)
            for i, c in enumerate(chunks)]


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("with_secondary", [False, True])
@pytest.mark.parametrize("string_parts", [True, False])
def test_engine_streaming_equals_jax(stream_models, secondary_models, depth,
                                     with_secondary, string_parts):
    jm, tm = stream_models
    js, ts = secondary_models if with_secondary else (None, None)
    chunks = _chunks(5, n=6, tail=100)  # the short final flush has no frames
    jeng = JEngine(model_name=jm)
    teng = TEngine(model_name=tm, device="cpu")
    ref = _run_stream(jeng, chunks, secondary_model=js,
                      return_string_parts=string_parts, pipeline_depth=depth)
    got = _run_stream(teng, chunks, secondary_model=ts,
                      return_string_parts=string_parts, pipeline_depth=depth)
    assert got == ref
    assert got[-1]  # a non-empty final
    # the engine is ready for the next stream: a second pass is identical
    assert _run_stream(teng, chunks, secondary_model=ts,
                       return_string_parts=string_parts, pipeline_depth=depth) == got


def test_short_first_chunk_is_refused(stream_models):
    _, tm = stream_models
    eng = TEngine(model_name=tm, device="cpu")
    eng.enable_streaming()
    with pytest.raises(WrongUsageOfListen):
        eng.streaming_transcribe(np.ones(640, np.float32), is_last=False, is_first=True)


class ScriptedFeed:
    """Stand-in for listen_in_background's get_data: one scripted
    (is_last, chunk) per consumer pass, NoDataInBuffer between items."""

    def __init__(self, items, empty=NoDataInBuffer):
        self.items = list(items)
        self.starve = False
        self.empty = empty  # each package catches its own exception class

    def get_data(self):
        if self.starve or not self.items:
            self.starve = False
            raise self.empty
        self.starve = True
        return self.items.pop(0)

    def stopper(self, wait_for_stop=True):
        pass


def _drain(rec, model, script, empty=NoDataInBuffer):
    feed = ScriptedFeed(script, empty)
    rec.listen_in_background = lambda source: (feed.stopper, feed.get_data)
    rec.enable_real_time_streaming(model, string_parts=True)

    class Source:  # real_time_streaming reads only the sampling rate here
        sampling_rate = 16000

    gen = rec.real_time_streaming(Source())
    yields = []
    while True:
        is_last, out = next(gen)
        yields.append((is_last, out))
        if is_last:
            break
    rec.stream = False
    return yields


def test_real_time_streaming_matches_direct_engine_and_jax(stream_models):
    """The generator's accumulation (8640 samples first, 6240 after at
    context 20) replayed by direct engine calls, and the JAX generator."""
    jm, tm = stream_models
    step = 3200
    rng = np.random.default_rng(7)
    wave = (rng.uniform(-1, 1, 22 * step) * 0.3 * 32767).astype(np.float32)
    chunks = [wave[i * step:(i + 1) * step] for i in range(22)]
    script = [(i == len(chunks) - 1, c) for i, c in enumerate(chunks)]

    got = _drain(TRecognizer(device="cpu"), tm, script)
    assert got == _drain(JRecognizer(compute_dtype="float32"), jm, script,
                         JNoDataInBuffer)

    context = tm.context
    general_req = 160 * 2 + 160 * ((context - 1) * 2 - 1)
    first_req = general_req + 160 * 15
    assert (first_req, general_req) == (8640, 6240)
    eng = TEngine(model_name=tm, device="cpu")
    eng.enable_streaming(secondary_model=None, return_string_parts=True)
    expected, acc, first = [], np.zeros(0, np.float32), True
    for is_last, c in script:
        acc = np.concatenate([acc, c])
        if first:
            if len(acc) >= first_req:
                assert eng.streaming_transcribe(acc, is_last=False, is_first=True) == ""
                acc, first = np.zeros(0, np.float32), False
        elif is_last or len(acc) >= general_req:
            out = eng.streaming_transcribe(acc, is_last=is_last, is_first=False)
            if out:
                expected.append((is_last, out))
            acc = np.zeros(0, np.float32)
    assert got == expected
    assert got[-1][0] is True and len(got) > 2


def test_disable_real_time_streaming_restores(stream_models):
    _, tm = stream_models
    rec = TRecognizer(device="cpu")
    stopped = []
    rec.enable_real_time_streaming(tm)
    rec.stream_thread_stopper = lambda wait_for_stop=True: stopped.append(wait_for_stop)
    rec.disable_real_time_streaming()
    assert rec.stream is False and stopped == [False]
    assert rec.danspeech_recognizer.greedy_decoder is None


def test_disable_before_any_listener_started(stream_models):
    """Direct streaming_transcribe use never starts a listener thread; the
    JAX package's disable then calls a None stopper, the port does not."""
    _, tm = stream_models
    rec = TRecognizer(device="cpu")
    rec.enable_real_time_streaming(tm)
    rec.disable_real_time_streaming()
    assert rec.stream is False


def _pcm(seed=0):
    """0.5 s silence, 1.5 s speech-level noise, 1.5 s silence: 16-bit PCM."""
    rng = np.random.default_rng(seed)
    speech = np.clip(rng.normal(size=24000) * 3000.0, -32768, 32767)
    return np.concatenate([np.zeros(8000), speech, np.zeros(24000)]).astype("<i2").tobytes()


def _fake_source(base, pcm):
    class FakeSource(base):
        sampling_rate, sampling_width, chunk = 16000, 2, 1024

        def __init__(self):
            self.stream = None

        def __enter__(self):
            self.stream = _PCMStream(pcm, 2)
            return self

        def __exit__(self, *exc):
            self.stream = None

    return FakeSource()


def _listen(rec, source):
    rec.stream = True
    out = []
    with source as s:
        for is_last, frames in rec.listen_stream(s):
            out.append((is_last, frames))
            if is_last:
                break
    return out


def test_listen_stream_equals_jax():
    """The energy-endpointed chunk generator: leading context, the phrase
    buffer by buffer, the final after the pause, on the same PCM."""
    pcm = _pcm()
    got = _listen(TRecognizer(device="cpu"), _fake_source(TSpeechSource, pcm))
    ref = _listen(JRecognizer(compute_dtype="float32"), _fake_source(JSpeechSource, pcm))
    assert got == ref
    assert got[-1][0] is True and len(got) > 3


def test_listen_in_background_delivers_listen_stream_chunks():
    pcm = _pcm(1)
    rec = TRecognizer(device="cpu")
    expected = [TRecognizer.get_audio_data(f if isinstance(f, list) else [f],
                                           _fake_source(TSpeechSource, pcm))
                for _, f in _listen(rec, _fake_source(TSpeechSource, pcm))]
    rec.stream = True
    stopper, get_data = rec.listen_in_background(_fake_source(TSpeechSource, pcm))
    got, deadline = [], time.monotonic() + 30
    try:
        while not (got and got[-1][0]):
            assert time.monotonic() < deadline, "no final chunk from the listener"
            try:
                got.append(get_data())
            except NoDataInBuffer:
                time.sleep(0.01)
    finally:
        rec.stream = False
        stopper(wait_for_stop=True)
    assert len(got) == len(expected)
    for (_, arr), ref in zip(got, expected):
        np.testing.assert_array_equal(arr, ref)


def test_uni_model_transcribe_batch_equals_jax(stream_models):
    jm, tm = stream_models
    rng = np.random.default_rng(8)
    recs = [np.clip(rng.normal(size=n) * 3000, -32768, 32767).astype(np.int16)
            for n in (16000, 30000, 9000, 47000, 4000)]
    recs += [rng.normal(size=n).astype(np.float32) * 1500 for n in (20000, 5000)]
    jeng = JEngine(model_name=jm)
    teng = TEngine(model_name=tm, device="cpu")
    ref = jeng.transcribe_batch(recs)
    assert teng.transcribe_batch(recs) == ref
    assert any(ref)


def test_uni_forward_bf16_matches_jax_pallas(stream_models):
    jm, tm = stream_models
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 1, 161, 90)).astype(np.float32)
    lengths = np.array([90, 51], np.int32)
    x *= (np.arange(90)[None, :] < lengths[:, None])[:, None, None, :]
    ref, ref_len = jds.forward(jds.cast_matmul_weights(jm.params), jm.config,
                               jnp.asarray(x), jnp.asarray(lengths), rnn_impl="pallas")
    tp = tds.cast_matmul_weights(tm.params)
    got, got_len = tds.forward(tp, tm.config, torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=BF16_ATOL, rtol=0)
    plain, _ = tds.forward(tp, tm.config, torch.from_numpy(x), torch.from_numpy(lengths),
                           rnn_impl="plain")
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


@pytest.mark.parametrize(
    "requested,device,expected",
    [
        ("auto", "cuda", "bfloat16"),
        ("bfloat16", "cuda", "bfloat16"),
        ("auto", "cpu", "float32"),
        ("float32", "cpu", "float32"),
        ("bfloat16", "cpu", "bfloat16"),
        ("float32", "cuda", "float32"),
    ],
)
def test_compute_dtype_resolution(requested, device, expected):
    assert _resolve_compute_dtype(requested, torch.device(device)) == expected


@pytest.mark.parametrize("rnn_type", ["gru", "lstm", "rnn"])
def test_float32_on_cuda_is_refused(rnn_type, monkeypatch):
    """Float32 on CUDA resolves, and serves every rnn_type through the
    recurrent kernels' float32 variants (GRU B1-B4, LSTM B5-B7, tanh B8-B9):
    no type is refused. A float32 engine on CUDA holds the model's weights
    in float32 for the device (the move to the device is recorded here, no
    card needed)."""
    cfg = TConfig(model_name="x", rnn_type=rnn_type, rnn_hidden_size=8, rnn_layers=1,
                  conv_layers=2)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert _resolve_compute_dtype("float32", cuda) == "float32"
    moved = []
    monkeypatch.setattr(tds, "params_to", lambda params, dev: moved.append(dev) or params)
    eng = TEngine(device="cpu", compute_dtype="float32")
    eng.device = cuda  # as a float32 engine on the card holds it
    model = TModel.init_random(cfg, seed=0)
    params = eng._device_params(model)
    assert moved == [cuda] and params["rnns"][0]["fwd"].w_hh.dtype == torch.float32
    with pytest.raises(ValueError):
        _resolve_compute_dtype("float16", cpu)
