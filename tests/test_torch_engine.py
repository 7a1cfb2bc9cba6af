"""Batch transcription of the PyTorch port against the JAX package (CPU).

Greedy transcripts must be exactly equal to the JAX engine's in float32,
over the ``tests/data`` clips and seeded waveforms (int16 and float),
whatever the dispatch groups. The port plans its groups by padded volume and
recurrent walk (``_plan_groups``), where the JAX engine merges length
buckets greedily: the port's plans are held to the cost they minimise.
"""

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from danspeech_tpu.engine import DanSpeechRecognizer as JRecognizerEngine
from danspeech_tpu.models import DeepSpeechModel as JModel
from danspeech_tpu.models.config import DeepSpeechConfig as JConfig
from danspeech_tpu.recognizer import Recognizer as JRecognizer
from danspeech_tpu_torch import Recognizer as TRecognizer
from danspeech_tpu_torch.audio import load_audio, load_audio_pcm16
from danspeech_tpu_torch.engine import WIDE_BLOCK_STEP
from danspeech_tpu_torch.engine import DanSpeechRecognizer as TRecognizerEngine
from danspeech_tpu_torch.models import DeepSpeechModel as TModel
from danspeech_tpu_torch.models.config import DeepSpeechConfig as TConfig
from danspeech_tpu_torch.ops import persist_plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "gpu_bench"))
import mixes  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")
CFG = dict(model_name="small", rnn_hidden_size=32, rnn_layers=2, conv_layers=3)
SECOND = TRecognizerEngine.SAMPLE_BUCKET
# the recurrent layers of the benchmark's three models
LSTM_1024 = dict(rnn_type="lstm", rnn_hidden_size=1024, rnn_layers=5, conv_layers=2)
GRU_1200 = dict(rnn_type="gru", rnn_hidden_size=1200, rnn_layers=9, conv_layers=3)
UNI_2000 = dict(rnn_type="gru", rnn_hidden_size=2000, rnn_layers=5, conv_layers=2,
                bidirectional=False)


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


def planner(**config) -> TRecognizerEngine:
    """An engine that plans for a model of ``config`` (no weights made)."""
    eng = TRecognizerEngine(device="cpu")
    eng.model = SimpleNamespace(config=TConfig(**config))
    return eng


def group_cost(eng, plans) -> float:
    """Padded volume and walk of ``plans``, as ``_plan_groups`` counts them."""
    total = 0.0
    for idxs, maxlen in plans:
        q = eng._row_quantum(len(idxs))
        total += (q + persist_plan.GROUP_ROWS * eng._walk_weight(q)) * maxlen
    return total


def greedy_plans(eng, recordings, inflation=1.6):
    """The plans of the JAX engine's scheduler: length buckets, then adjacent
    buckets merged while the padded volume stays within ``inflation`` of
    the merged plans' own."""
    buckets = {}
    for i, r in enumerate(recordings):
        buckets.setdefault(-(-max(len(r), 1) // SECOND) * SECOND, []).append(i)
    top = eng.MAX_BATCH_ROWS
    merged = []
    for maxlen in sorted(buckets):
        idxs = buckets[maxlen]
        for s in range(0, len(idxs), top):
            part = idxs[s : s + top]
            own = eng._row_quantum(len(part)) * maxlen
            if merged and len(merged[-1][0]) + len(part) <= top:
                joint = eng._row_quantum(len(merged[-1][0]) + len(part)) * maxlen
                if joint <= inflation * (merged[-1][2] + own):
                    merged[-1] = (merged[-1][0] + part, maxlen, merged[-1][2] + own)
                    continue
            merged.append((list(part), maxlen, own))
    return [(idxs, maxlen) for idxs, maxlen, _ in merged]


def check_plans(eng, recs, plans):
    """Every index once; each group at most MAX_BATCH_ROWS rows, at its
    longest row's bucket, and contiguous in length order."""
    assert sorted(i for idxs, _ in plans for i in idxs) == list(range(len(recs)))
    previous = -1
    for idxs, maxlen in plans:
        lengths = [len(recs[i]) for i in idxs]
        assert 1 <= len(idxs) <= eng.MAX_BATCH_ROWS
        assert lengths == sorted(lengths) and lengths[0] >= previous
        assert maxlen == -(-max(lengths[-1], 1) // SECOND) * SECOND
        previous = lengths[-1]


@pytest.mark.parametrize("config,seed", [(LSTM_1024, 0), (GRU_1200, 1), (UNI_2000, 2),
                                         (CFG, 3)])
def test_plan_groups_cut(config, seed):
    """Random batches: the plan is whole and ordered, and never costs more
    than the JAX engine's greedy merge, nor than one group a bucket."""
    eng = planner(**config)
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    recs = [np.zeros(int(k), np.int16) for k in rng.integers(100, 200000, size=n)]
    plans = eng._plan_groups(recs)
    check_plans(eng, recs, plans)
    cost = group_cost(eng, plans)
    assert cost <= group_cost(eng, greedy_plans(eng, recs)) * (1 + 1e-12)
    assert cost <= group_cost(eng, greedy_plans(eng, recs, inflation=0.0)) * (1 + 1e-12)


def cell_calls(traffic: str, seed: int = 2**31 + 12345):
    """The calls of a benchmark traffic's pool, as zero waveforms."""
    with open(os.path.join(ROOT, "gpu_bench", "traffic", f"{traffic}.json")) as f:
        mix = json.load(f)
    return [[np.zeros(int(k), np.int16) for k in call] for call in mixes.lengths(mix, seed)]


def same_length(*counts_and_seconds):
    return [np.zeros(int(s * SECOND), np.int16)
            for n, s in counts_and_seconds for _ in range(n)]


@pytest.mark.parametrize("config,calls,want", [
    # the cells' traffic: 128 rows of 2-20 s and of 1-8 s a call
    (LSTM_1024, cell_calls("batch128_2to20s"), [(64, 11), (64, 20)]),
    (GRU_1200, cell_calls("batch128_1to8s"), [(64, 5), (64, 8)]),
    (UNI_2000, cell_calls("batch128_1to8s"), [(64, 5), (64, 8)]),
    (LSTM_1024, [same_length((128, 6.5))], [(128, 7)]),
    (LSTM_1024, [same_length((64, 9), (64, 10))], [(128, 10)]),
    # B1 at H = 2000 walks 128 rows as two 64-row blocks anyway
    (UNI_2000, [same_length((64, 9), (64, 10))], [(64, 9), (64, 10)]),
    (LSTM_1024, [same_length((1, 3.2))], [(1, 4)]),
], ids=["lstm-2to20s", "gru-1to8s", "uni-1to8s", "one-bucket", "lstm-9s-10s",
        "uni-9s-10s", "one-row"])
def test_plan_groups_table(config, calls, want):
    """(rows, bucket seconds) of each group for the traffics the planner was
    built for: rows sorted by length and cut at the walk's 64-row block."""
    eng = planner(**config)
    for recs in calls:
        plans = eng._plan_groups(recs)
        check_plans(eng, recs, plans)
        assert [(len(idxs), maxlen // SECOND) for idxs, maxlen in plans] == want


def test_walk_weights_follow_the_plans():
    """w is 1 up to 64 rows; above, the H100's plan: one 128-row block (B3,
    B5) or two 64-row blocks one after the other (B1 at H = 2000)."""
    for config, wide in ((LSTM_1024, WIDE_BLOCK_STEP), (GRU_1200, WIDE_BLOCK_STEP),
                         (UNI_2000, 2.0)):
        eng = planner(**config)
        assert [eng._walk_weight(q) for q in (1, 16, 32, 64)] == [1.0] * 4
        assert eng._walk_weight(128) == wide


def test_transcribe_batch_equals_jax(engines):
    jeng, teng = engines
    recs = _recordings()
    ref = jeng.transcribe_batch(recs)
    got = teng.transcribe_batch(recs)
    assert got == ref
    assert teng.transcribe_batch(recs, show_all=True) == [[s] for s in ref]


def test_mixed_batch_above_64_rows_equals_jax(engines):
    """More than 64 rows of 0.05 to 2.9 s, int16 and float: the port cuts
    them into other groups than the JAX engine, the transcripts are the
    same and the counters add the call's plan."""
    jeng, teng = engines
    rng = np.random.default_rng(7)
    recs = [np.clip(rng.normal(size=n) * 3000, -32768, 32767).astype(np.int16)
            for n in rng.integers(800, 46000, size=60)]
    recs += [rng.normal(size=n) * 1500.0 for n in rng.integers(800, 46000, size=12)]
    plans = teng._plan_groups(recs)
    assert len(plans) > 1
    assert plans != jeng._plan_groups(recs)
    before = dict(teng.plan_counts)
    assert teng.transcribe_batch(recs) == jeng.transcribe_batch(recs)
    after = teng.plan_counts
    assert after["calls"] == before["calls"] + 1
    assert after["groups"] == before["groups"] + len(plans)
    assert after["rows"] == before["rows"] + len(recs)
    padded = sum(teng._row_quantum(len(i)) * m for i, m in plans) / 16000
    assert after["padded_row_s"] == pytest.approx(before["padded_row_s"] + padded)
    walked = sum(m for _, m in plans) / 16000
    assert after["walked_s"] == pytest.approx(before["walked_s"] + walked)


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
