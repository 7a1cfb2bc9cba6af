"""Mozilla DeepSpeech 0.9.3 in the port (``models/mozilla.py``,
``ops/mfcc.py``), held on the CPU at a small size to the benchmark's plain
float32 reference (``gpu_bench/reference/mozilla_ref.py``) and to a float64
numpy transcription of TensorFlow's MFCC.

The weights are a state dict in the release's TensorFlow layout (dense
``layer_k/weights`` (in, out), the LSTM's one (2H, 4H) ``kernel`` in gate
order i, c~, f, o), with random biases, loaded through
``DeepSpeechModel.load_model_package``. The comparison (:func:`disagrees`)
holds the port's logits to the reference's and its texts, through
``recognize`` and ``recognize_batch``, to the reference's greedy texts; each
fault the loader, the windows, the clip or the decoder could have makes it
fail. The planner's tests replay the benchmark's pools.
"""

import hashlib
import json
import math
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from danspeech_tpu_torch import Recognizer
from danspeech_tpu_torch.engine import STEP_TWO_BLOCKS
from danspeech_tpu_torch.engine import DanSpeechRecognizer as Engine
from danspeech_tpu_torch.models import DeepSpeechConfig, DeepSpeechModel, mozilla
from danspeech_tpu_torch.models import checkpoint
from danspeech_tpu_torch.ops import mfcc as mfcc_ops
from danspeech_tpu_torch.ops import persist_plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "gpu_bench"))
import check  # noqa: E402
import mixes  # noqa: E402
from reference.mozilla_ref import LSTM_SCOPE  # noqa: E402
from reference.mozilla_ref import Model as Reference  # noqa: E402

HIDDEN = 48
LABELS = mozilla.LABELS
BLANK = LABELS.index("_")
CONFIG = {"model_name": "mozilla-test", "family": "mozilla", "rnn_hidden_size": HIDDEN,
          "labels": LABELS, "audio_conf": mozilla.AUDIO_CONF}
# unequal lengths, the longest first: 1.2 s, 0.5 s, 0.9 s, 0.7 s
LENGTHS = (19200, 8000, 14400, 11200)
# float32 on both sides, summed in other orders (the DFT, the filterbank,
# the products): the logits agree to about 1e-6 of the largest; they are held
# to 1e-4 of it
LOGIT_RTOL = 1e-4


def waves(seed: int, lengths=LENGTHS, amplitude: float = 3000.0) -> list:
    """int16 noise in bursts of 50-400 ms at gains of -40 to 0 dB."""
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        gains = np.repeat(10.0 ** (rng.uniform(-40, 0, size=n // 800 + 1) / 20),
                          rng.integers(800, 6400, size=n // 800 + 1))[:n]
        gains = np.pad(gains, (0, n - len(gains)), mode="edge")
        out.append(np.clip(np.round(rng.normal(size=n) * amplitude * gains), -32768, 32767)
                   .astype(np.int16))
    return out


def tf_state_dict(seed: int = 0, hidden: int = HIDDEN, layer_1_gain: float = 1.0) -> dict:
    """The release's variables: Glorot-uniform kernels, biases U(-0.1, 0.1)
    (the release initialises them to zeros; random ones test their
    handling); ``layer_1`` scaled by ``layer_1_gain``."""
    rng = np.random.default_rng(seed)
    widths = {"layer_1": (19 * 26, hidden), "layer_2": (hidden, hidden),
              "layer_3": (hidden, hidden), "layer_5": (hidden, hidden),
              "layer_6": (hidden, len(LABELS))}
    sd = {}

    def glorot(fan_in, fan_out):
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-bound, bound, size=(fan_in, fan_out))

    for name, (fan_in, fan_out) in widths.items():
        gain = layer_1_gain if name == "layer_1" else 1.0
        sd[f"{name}/weights"] = glorot(fan_in, fan_out) * gain
        sd[f"{name}/bias"] = rng.uniform(-0.1, 0.1, size=fan_out)
    sd[f"{LSTM_SCOPE}/kernel"] = glorot(2 * hidden, 4 * hidden)
    sd[f"{LSTM_SCOPE}/bias"] = rng.uniform(-0.1, 0.1, size=4 * hidden)
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}


def recognizer(sd: dict) -> Recognizer:
    model = DeepSpeechModel.load_model_package({**CONFIG, "state_dict": sd})
    return Recognizer(model=model, device="cpu")


def port_logits(rec: Recognizer, batch: list) -> list:
    """The port's float32 logits of ``batch`` in one dispatch group, through
    the engine's staging and the model's forward pass."""
    eng = rec.danspeech_recognizer
    (idxs, maxlen), = eng._plan_groups(batch)
    staged, lengths = eng._stage_group(batch, idxs, maxlen)
    with torch.inference_mode():
        logits, out_lens = mozilla.forward(eng._compute_params, staged,
                                           torch.from_numpy(lengths), softmax=False)
    got = [None] * len(batch)
    for j, i in enumerate(idxs):
        got[i] = logits[j, : int(out_lens[j])]
    return got


def disagrees(rec: Recognizer, sd: dict, batch: list) -> list:
    """What fails of the comparison: the logits beyond LOGIT_RTOL of the
    largest, or a text of ``recognize_batch`` or ``recognize`` not the
    reference's greedy text (no alignment of it at every frame's best
    logit)."""
    ref = Reference(sd, CONFIG).logits(batch)
    got = port_logits(rec, batch)
    scale = max(float(r.abs().max()) for r in ref)
    faults = []
    if any(g.shape != r.shape for g, r in zip(got, ref)):
        faults.append("frames")
    elif max(float((g - r).abs().max()) for g, r in zip(got, ref)) > LOGIT_RTOL * scale:
        faults.append("logits")
    texts = rec.recognize_batch(batch)
    if any(check.text_gap(r.numpy(), t, LABELS, BLANK) > LOGIT_RTOL * scale
           for r, t in zip(ref, texts)):
        faults.append("recognize_batch")
    if check.text_gap(ref[0].numpy(), rec.recognize(batch[0]), LABELS, BLANK) > 0:
        faults.append("recognize")
    return faults


# ---------------------------------------------------------------------------
# The MFCC against a float64 transcription of TensorFlow's ops
# ---------------------------------------------------------------------------


def tf_mfcc(wave: np.ndarray) -> np.ndarray:
    """``audio_spectrogram(magnitude_squared=True)`` then ``mfcc`` in float64,
    written from the C++ kernels' loops: (frames, 26)."""
    x = wave.astype(np.float64) / 32768.0
    n_frames = 1 + (len(x) - 512) // 320 if len(x) >= 512 else 0
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(512) / 512)
    mel = lambda f: 1127.0 * math.log1p(f / 700.0)  # noqa: E731
    lo, hi = mel(20.0), mel(8000.0)
    centres = [lo + (hi - lo) / 41 * (i + 1) for i in range(41)]
    hz = 0.5 * 16000 / 256
    start, end = int(1.5 + 20.0 / hz), int(8000.0 / hz)
    out = np.zeros((n_frames, 26))
    for t in range(n_frames):
        power = np.abs(np.fft.rfft(x[320 * t : 320 * t + 512] * window)) ** 2
        channels = np.zeros(40)
        channel = 0
        for i in range(start, end + 1):
            m = mel(i * hz)
            while channel < 40 and centres[channel] < m:
                channel += 1
            c = channel - 1
            w = ((centres[c + 1] - m) / (centres[c + 1] - centres[c]) if c >= 0
                 else (centres[0] - m) / (centres[0] - lo))
            if c >= 0:
                channels[c] += math.sqrt(power[i]) * w
            if c + 1 < 40:
                channels[c + 1] += math.sqrt(power[i]) * (1 - w)
        logs = np.log(np.maximum(channels, 1e-12))
        for k in range(26):
            out[t, k] = math.sqrt(2 / 40) * sum(
                logs[j] * math.cos(math.pi * k * (j + 0.5) / 40) for j in range(40))
    return out


def test_mfcc_matches_tensorflow_in_float64():
    """Rows of 0.45 s, 1 s, 511 samples (no whole window) and one of silence,
    padded into one batch: each row's frames to 2e-4 of the largest
    coefficient (float32 against float64), zeros past its frame count, and
    the zero-padded coefficients 26..31 zeros."""
    rows = waves(3, (7200, 16000, 511))
    rows.append(np.zeros(4000, np.int16))
    n = max(len(r) for r in rows)
    batch = torch.zeros((len(rows), n), dtype=torch.int16)
    for i, r in enumerate(rows):
        batch[i, : len(r)] = torch.from_numpy(r)
    lengths = torch.tensor([len(r) for r in rows])
    got, frames = mfcc_ops.mfcc(batch, lengths, width=32)
    assert frames.tolist() == [mfcc_ops.num_frames(len(r)) for r in rows] == [21, 49, 0, 11]
    assert float(got[..., 26:].abs().max()) == 0.0
    for i, r in enumerate(rows):
        want = tf_mfcc(r)
        n_frames = int(frames[i])
        scale = max(1.0, float(np.abs(want).max())) if n_frames else 1.0
        np.testing.assert_allclose(got[i, :n_frames, :26].double().numpy(), want,
                                   atol=2e-4 * scale, rtol=0)
        assert float(got[i, n_frames:].abs().sum()) == 0.0


def test_filterbank_and_dct_as_tensorflow_builds_them():
    bank = mfcc_ops.filterbank()
    assert bank.shape == (257, 40)
    # DC and bin 1 are excluded (HTK); the top bin (8 kHz) is the last used
    assert not bank[:2].any() and bank[2].any() and bank[256].any()
    # each used bin splits its magnitude between two neighbouring channels,
    # but for the first channel's rising edge and the last one's falling edge
    sums = bank[2:].sum(axis=1)
    assert np.all((sums > 0) & (sums <= 1 + 1e-12))
    dct = mfcc_ops.dct_matrix(width=32)
    assert dct[:, 26:].sum() == 0 and dct[:, 0] == pytest.approx(math.sqrt(2 / 40))


# ---------------------------------------------------------------------------
# Loading the release's layout
# ---------------------------------------------------------------------------


def test_loader_reorders_the_gates_and_round_trips():
    sd = tf_state_dict()
    config = checkpoint.config_from_package(CONFIG)
    assert config.family == "mozilla" and config.blank_index == 28
    assert (config.rnn_type, config.rnn_layers, config.bidirectional) == ("lstm", 1, False)
    params = checkpoint.params_from_state_dict(sd, config)
    kernel, bias = sd[f"{LSTM_SCOPE}/kernel"], sd[f"{LSTM_SCOPE}/bias"]
    h = HIDDEN
    lstm = params["lstm"]
    # the port's i, f, g, o from TensorFlow's i, c~, f, o
    for port, tf in ((0, 0), (1, 2), (2, 1), (3, 3)):
        assert torch.equal(lstm.w_ih[:, port * h : (port + 1) * h],
                           kernel[:h, tf * h : (tf + 1) * h])
        assert torch.equal(lstm.w_hh[:, port * h : (port + 1) * h],
                           kernel[h:, tf * h : (tf + 1) * h])
        assert torch.equal(lstm.b_ih[port * h : (port + 1) * h], bias[tf * h : (tf + 1) * h])
    assert not lstm.b_hh.any() and lstm.w_ih.is_contiguous() and lstm.w_hh.is_contiguous()
    back = checkpoint.state_dict_from_params(params, config)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v.numpy())


def test_dsz_round_trip_and_ds2_configs_unchanged(tmp_path):
    model = DeepSpeechModel.load_model_package({**CONFIG, "state_dict": tf_state_dict()})
    path = str(tmp_path / "m.dsz")
    model.save(path)
    loaded = DeepSpeechModel.load_model(path)
    assert loaded.config == model.config and loaded.labels[-1] == "_"
    for a, b in zip(loaded.params["lstm"], model.params["lstm"]):
        assert torch.equal(a, b)
    # a DeepSpeech2 config is written as before the family field, so that
    # older readers take it
    assert "family" not in DeepSpeechConfig(model_name="x").to_dict()
    assert DeepSpeechConfig.from_dict(DeepSpeechConfig(model_name="x").to_dict()).family == "ds2"


def test_random_init_counts_the_published_parameters():
    config = DeepSpeechConfig(**CONFIG)
    params = DeepSpeechModel.init_random(config, seed=1).params
    h = HIDDEN
    want = (494 * h + h) + 3 * (h * h + h) + (2 * h * 4 * h + 4 * h) + (h * 29 + 29)
    # the tree holds the LSTM's zero b_hh besides the release's variables
    assert DeepSpeechModel(config, params).get_param_size() == want + 4 * h
    full = DeepSpeechConfig(**dict(CONFIG, rnn_hidden_size=2048))
    assert (494 * 2048 + 2048) + 3 * (2048 ** 2 + 2048) + (4096 * 8192 + 8192) \
        + (2048 * 29 + 29) == 47_224_861
    assert full.num_classes == 29


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sound():
    sd = tf_state_dict()
    return sd, recognizer(sd)


def test_port_matches_reference(sound):
    sd, rec = sound
    batch = waves(11)
    assert disagrees(rec, sd, batch) == []
    # the greedy paths change over time
    texts = rec.recognize_batch(batch)
    assert all(len(set(t)) > 2 for t in texts)


def test_port_matches_reference_where_the_clip_binds():
    """``layer_1`` scaled so that a share of its outputs reach 20: the clip
    binds, and the port still agrees."""
    sd = tf_state_dict(seed=1, layer_1_gain=40.0)
    batch = waves(12, amplitude=12000.0)
    ref = Reference(sd, CONFIG)
    feats = torch.nn.utils.rnn.pad_sequence([ref.features(w) for w in batch])
    pre = ref._windows(feats) @ sd["layer_1/weights"] + sd["layer_1/bias"]
    assert float((pre > mozilla.RELU_CLIP).float().mean()) > 0.05
    assert disagrees(recognizer(sd), sd, batch) == []


def test_short_rows_read_empty():
    """A row of fewer than 512 samples has no frame: an empty text, not an
    error, in a batch and alone."""
    sd = tf_state_dict()
    rec = recognizer(sd)
    batch = waves(13, (300, 16000, 511, 512))
    texts = rec.recognize_batch(batch)
    assert texts[0] == texts[2] == "" and rec.recognize(batch[0]) == ""
    ref = Reference(sd, CONFIG).logits(batch)
    assert [len(r) for r in ref] == [0, 49, 0, 1]
    assert check.text_gap(ref[1].numpy(), texts[1], LABELS, BLANK) == 0.0


def no_clip(monkeypatch):
    monkeypatch.setattr(mozilla, "RELU_CLIP", float("inf"))


def gates_unreordered(monkeypatch):
    """The loader takes TensorFlow's i, c~, f, o as the port's i, f, g, o."""
    monkeypatch.setattr(mozilla, "reorder_gates", lambda t, hidden: t)


def windows_shifted(monkeypatch):
    """Frame t's window centred on frame t - 1."""
    windows = mozilla.windows
    monkeypatch.setattr(mozilla, "windows", lambda f: torch.roll(windows(f), 1, dims=0))


def blank_first(monkeypatch):
    """The decoder takes index 0 (the space) for the blank."""
    build = Engine._build_decoder

    def first(self):
        decoder = build(self)
        decoder.blank_index = 0
        return decoder

    monkeypatch.setattr(Engine, "_build_decoder", first)


@pytest.mark.parametrize("fault", [no_clip, gates_unreordered, windows_shifted, blank_first])
def test_fault_fails_the_comparison(fault, monkeypatch):
    sd = tf_state_dict(seed=1, layer_1_gain=40.0)
    fault(monkeypatch)
    assert disagrees(recognizer(sd), sd, waves(12, amplitude=12000.0))


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------


def planner(**config) -> Engine:
    """An engine that plans for a model of ``config`` (no weights made)."""
    eng = Engine(device="cpu")
    eng.model = SimpleNamespace(config=DeepSpeechConfig(**config))
    return eng


# the four earlier cells: their models' recurrent layers and traffic, and a
# digest of their dispatch plans over three seeds' pools as they were before
# step plans were priced by their own grid (every plan of these models is
# persistent)
CELL_PLANS = {
    "primary-batch": (dict(rnn_type="gru", rnn_hidden_size=1200, rnn_layers=9,
                           conv_layers=3), "batch128_1to8s", "41163eb4c4783cfd"),
    "streaming-batch": (dict(rnn_type="gru", rnn_hidden_size=2000, rnn_layers=5,
                             conv_layers=2, bidirectional=False), "batch128_1to8s",
                        "41163eb4c4783cfd"),
    "primary-recognize": (dict(rnn_type="gru", rnn_hidden_size=1200, rnn_layers=9,
                               conv_layers=3), "single_1to8s", "834e9f7dead6cab9"),
    "librispeech-lstm-batch": (dict(rnn_type="lstm", rnn_hidden_size=1024, rnn_layers=5,
                                    conv_layers=2), "batch128_2to20s", "d39f14a895861bba"),
}


def pool_lengths(traffic: str, seed: int):
    with open(os.path.join(ROOT, "gpu_bench", "traffic", f"{traffic}.json")) as f:
        return mixes.lengths(json.load(f), seed)


@pytest.mark.parametrize("cell", sorted(CELL_PLANS))
def test_earlier_cells_plan_as_before(cell):
    config, traffic, digest = CELL_PLANS[cell]
    eng = planner(**config)
    h = hashlib.sha256()
    for seed in (7, 2**31 + 12345, 3000000101):
        for call in pool_lengths(traffic, seed):
            # the planner reads lengths only
            plans = eng._plan_groups([range(int(k)) for k in call])
            h.update(repr([(list(i), m) for i, m in plans]).encode())
    assert h.hexdigest()[:16] == digest


def test_step_plan_weight_follows_the_step_grid():
    """B5 at H = 2048 has no persistent plan on an H100: w is that of the step
    kernel's grid, one 64-row block (w = 1) up to 64 rows and two launched
    together (STEP_TWO_BLOCKS) above; two chains walk one after the other.
    The persistent plans' weights are as they were."""
    for q in (1, 16, 64, 65, 128):
        assert persist_plan.plan_lstm_forward(2048, q, 1, persist_plan.H100_SMS,
                                              persist_plan.H100_SMEM_OPTIN).design == "step"
    uni = planner(**dict(CONFIG, rnn_hidden_size=2048))
    assert [uni._walk_weight(q) for q in (1, 16, 32, 64, 128)] == [1.0] * 4 + [STEP_TWO_BLOCKS]
    bidi = planner(rnn_type="lstm", rnn_hidden_size=2048, rnn_layers=1, conv_layers=2)
    assert [bidi._walk_weight(q) for q in (1, 64, 128)] == [2.0, 2.0, 2 * STEP_TWO_BLOCKS]
    # two row blocks launched together cost less than two steps, more than one
    assert 1.0 < STEP_TWO_BLOCKS < 2.0
    assert persist_plan.STEP_ROWS == persist_plan.GROUP_ROWS == 64


def test_mozilla_cell_plans():
    """The Mozilla cell's pool: every row once, groups ordered by length, at
    most 128 rows each: two groups of 64 a call, as the LSTM cell's."""
    eng = planner(**dict(CONFIG, rnn_hidden_size=2048))
    for call in pool_lengths("batch128_2to20s_mozilla", 2**31 + 99):
        recs = [range(int(k)) for k in call]
        plans = eng._plan_groups(recs)
        assert sorted(i for idxs, _ in plans for i in idxs) == list(range(len(recs)))
        last = 0
        for idxs, maxlen in plans:
            lengths = [len(recs[i]) for i in idxs]
            assert lengths == sorted(lengths) and lengths[0] >= last and len(idxs) <= 128
            assert maxlen == -(-lengths[-1] // Engine.SAMPLE_BUCKET) * Engine.SAMPLE_BUCKET
            last = lengths[-1]
        assert [(len(idxs), maxlen // Engine.SAMPLE_BUCKET) for idxs, maxlen in plans] == \
            [(64, 11), (64, 20)]
