"""Mu-law staging (``transfer_format="ulaw"``) of the PyTorch port against
the JAX package and ``audioop`` (CPU).

The codec is a numpy copy (``audio/dsp.py``); the engine stages uint8 codes
and decodes them with its own function, ``engine.ulaw_decode``, which these
tests drive directly over all 256 codes (ROADMAP C2). Float32 on the CPU:
the port's and the JAX engine's transcripts are exactly equal.
"""

import warnings

import numpy as np
import pytest
import torch

from danspeech_tpu.audio import dsp as jdsp
from danspeech_tpu.engine import DanSpeechRecognizer as JEngine
from danspeech_tpu.models import DeepSpeechModel as JModel
from danspeech_tpu.models.config import DeepSpeechConfig as JConfig
from danspeech_tpu_torch.audio import dsp as tdsp
from danspeech_tpu_torch.engine import ULAW_ZERO, DanSpeechRecognizer as TEngine
from danspeech_tpu_torch.engine import ulaw_decode
from danspeech_tpu_torch.models import DeepSpeechModel as TModel
from danspeech_tpu_torch.models.config import DeepSpeechConfig as TConfig

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import audioop

CFG = dict(model_name="ulaw", rnn_hidden_size=32, rnn_layers=2, conv_layers=2)


def _waves(seed, n=5):
    rng = np.random.default_rng(seed)
    lens = rng.integers(4000, 30000, size=n)
    return [np.clip(rng.normal(size=k) * 4000.0, -32768, 32767).astype(np.int16)
            for k in lens]


def test_ulaw_encode_equals_jax_and_audioop_on_every_int16():
    x = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    got = tdsp.ulaw_encode(x)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jdsp.ulaw_encode(x))
    np.testing.assert_array_equal(
        got, np.frombuffer(audioop.lin2ulaw(x.tobytes(), 2), np.uint8))
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(tdsp.ulaw_decode_table(), jdsp.ulaw_decode_table())
    np.testing.assert_array_equal(
        tdsp.ulaw_decode_table(),
        np.frombuffer(audioop.ulaw2lin(codes.tobytes(), 2), np.int16))
    assert ULAW_ZERO == 0xFF and tdsp.ulaw_decode_table()[ULAW_ZERO] == 0


def test_engine_decode_equals_the_table_on_all_256_codes():
    """C2: the engine's own decode, not a retyped formula."""
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    got = ulaw_decode(codes)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), tdsp.ulaw_decode_table().astype(np.float32))
    # a 2-D batch decodes elementwise
    grid = codes.reshape(16, 16)
    np.testing.assert_array_equal(ulaw_decode(grid).numpy().reshape(-1), got.numpy())


def test_engine_forward_reads_uint8_through_ulaw_decode(monkeypatch):
    """_forward hands a uint8 batch to the module's ulaw_decode."""
    import danspeech_tpu_torch.engine as teng_mod

    seen = []
    real = teng_mod.ulaw_decode

    def spy(codes):
        seen.append(codes.dtype)
        return real(codes)

    monkeypatch.setattr(teng_mod, "ulaw_decode", spy)
    eng = TEngine(model_name=TModel.init_random(TConfig(**CFG), seed=1),
                  device="cpu", transfer_format="ulaw")
    eng.transcribe(_waves(2, 1)[0])
    assert seen == [torch.uint8]


@pytest.fixture(scope="module")
def engines():
    jm = JModel.init_random(JConfig(**CFG), seed=3)
    tm = TModel.init_random(TConfig(**CFG), seed=3)
    return (JEngine(model_name=jm, transfer_format="ulaw"),
            TEngine(model_name=tm, device="cpu", transfer_format="ulaw"),
            TEngine(model_name=tm, device="cpu"))


def test_ulaw_transcripts_equal_jax_and_the_exact_path_on_round_tripped_audio(engines):
    jeng, teng, exact = engines
    waves = _waves(4, 7)
    got = teng.transcribe_batch(waves)
    assert got == jeng.transcribe_batch(waves)
    assert teng.transcribe(waves[0]) == jeng.transcribe(waves[0])
    rounded = [tdsp.ulaw_decode_table()[tdsp.ulaw_encode(w)] for w in waves]
    assert got == exact.transcribe_batch(rounded)
    # float rows are rounded to int16 before the encode
    floats = [w.astype(np.float32) + 0.25 for w in waves[:3]]
    assert teng.transcribe_batch(floats) == jeng.transcribe_batch(floats)


def test_ulaw_probabilities_equal_the_exact_path_on_round_tripped_audio(engines):
    _, teng, exact = engines
    waves = _waves(5, 3)
    rounded = [tdsp.ulaw_decode_table()[tdsp.ulaw_encode(w)] for w in waves]
    idxs, maxlen = teng._plan_groups(waves)[0]
    codes, lengths = teng._stage_group(waves, idxs, maxlen)
    pcm, lengths2 = exact._stage_group(rounded, idxs, maxlen)
    np.testing.assert_array_equal(lengths, lengths2)
    lens = torch.from_numpy(lengths)
    p1, n1 = teng._forward(teng._compute_params, codes, lens)
    p2, n2 = exact._forward(exact._compute_params, pcm, lens)
    assert torch.equal(n1, n2)
    assert torch.equal(p1[: len(idxs)], p2[: len(idxs)])


def test_staged_pad_tails_decode_to_zero(engines):
    _, teng, _ = engines
    waves = _waves(6, 3)  # three rows of different lengths: a pad row to 4
    idxs, maxlen = teng._plan_groups(waves)[0]
    buf, lengths = teng._stage_group(waves, idxs, maxlen)
    assert buf.dtype == torch.uint8 and buf.shape == (4, maxlen)
    decoded = ulaw_decode(buf).numpy()
    for j, i in enumerate(idxs):
        n = len(waves[i])
        assert lengths[j] == n
        assert (buf[j, n:] == ULAW_ZERO).all()
        assert (decoded[j, n:] == 0).all()
        np.testing.assert_array_equal(
            decoded[j, :n], tdsp.ulaw_decode_table()[tdsp.ulaw_encode(waves[i])])
    assert (decoded[len(idxs):] == 0).all()  # the pad row is silent
    assert lengths[len(idxs)] == lengths[0]


def test_staging_cache_keys_by_dtype(engines):
    """A uint8 group never receives an int16 buffer of the same shape."""
    _, teng, _ = engines
    waves = _waves(7, 2)
    idxs, maxlen = teng._plan_groups(waves)[0]
    teng._staging_used = set()
    teng.transfer_format = "auto"
    try:
        pcm, _ = teng._stage_group(waves, idxs, maxlen)
        teng.transfer_format = "ulaw"
        codes, _ = teng._stage_group(waves, idxs, maxlen)
    finally:
        teng.transfer_format = "ulaw"
    assert pcm.dtype == torch.int16 and codes.dtype == torch.uint8
    assert pcm.shape == codes.shape
    assert pcm.data_ptr() != codes.data_ptr()
    keys = {k for k in teng._staging if k[0] == (len(pcm), maxlen)}
    assert keys == {((len(pcm), maxlen), torch.int16), ((len(pcm), maxlen), torch.uint8)}
