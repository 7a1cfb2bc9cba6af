"""deepspeech.pytorch's bidirectional LSTM DeepSpeech2 in the port, held to
the benchmark's plain float32 reference (``gpu_bench/reference/lstm_ref.py``)
on the CPU at a small size.

The model is built as deepspeech.pytorch saves it: its state dict made from
``nn.Conv2d``, ``nn.BatchNorm2d``, ``nn.LSTM(bidirectional=True)``,
``nn.BatchNorm1d`` and ``nn.Linear`` modules, so every recurrent weight is a
contiguous (4H, I) or (4H, H) tensor, then loaded through
``DeepSpeechModel.load_model_package``. Two conv layers, 3 x 48 LSTM, the 29
labels of its ``labels.json``; BatchNorm's statistics calibrated through the
reference, the head sharpened so that the greedy paths change over time.
"""

import contextlib
import dataclasses
import os
import sys
from collections import Counter

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from danspeech_tpu_torch import Recognizer
from danspeech_tpu_torch.models import DeepSpeechModel
from danspeech_tpu_torch.models import deepspeech as ds
from danspeech_tpu_torch.models.checkpoint import config_from_package, params_from_state_dict
from danspeech_tpu_torch.ops import lstm_cuda
from danspeech_tpu_torch.ops import stft as stft_ops

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "gpu_bench"))
from reference.lstm_ref import Model as Reference  # noqa: E402

LABELS = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ "
HIDDEN, LAYERS = 48, 3
HEAD_GAIN = 16.0
AUDIO = {"normalize": True, "sampling_rate": 16000, "window": "hamming",
         "window_stride": 0.01, "window_size": 0.02}
CONFIG = {"model_name": "ds2-lstm-test", "rnn_type": "lstm", "rnn_hidden_size": HIDDEN,
          "rnn_layers": LAYERS, "conv_layers": 2, "bidirectional": True, "context": 20,
          "streaming_model": False, "labels": LABELS, "audio_conf": AUDIO}
# (kernel, stride, padding) of deepspeech.pytorch's two conv layers
CONVS = (((41, 11), (2, 2), (20, 5), 1), ((21, 11), (2, 1), (10, 5), 32))
# float32 on both sides, summed in other orders (the STFT, the folded
# BatchNorm, the products): 3e-6 to 5.4e-6 of the largest logit (about 30)
# over three batches. Logits are held to 1e-4 of it, 20 times that; starting
# each reverse chain at the batch's last frame instead of the row's own moves
# them by 0.41 to 0.50 of it
LOGIT_RTOL = 1e-4
# unequal lengths, the longest first: 1.1 s, 0.62 s, 0.35 s, 0.9 s
LENGTHS = (17600, 9920, 5600, 14400)


def waves(seed: int, lengths=LENGTHS) -> list:
    """int16 noise in bursts of 50-400 ms at gains of -40 to 0 dB."""
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        gains = np.repeat(10.0 ** (rng.uniform(-40, 0, size=n // 800 + 1) / 20),
                          rng.integers(800, 6400, size=n // 800 + 1))[:n]
        gains = np.pad(gains, (0, n - len(gains)), mode="edge")
        out.append(np.clip(np.round(rng.normal(size=n) * 3000 * gains), -32768, 32767)
                   .astype(np.int16))
    return out


def module_state_dict(seed: int = 0) -> dict:
    """The float32 state dict in deepspeech.pytorch's layout, from its
    modules' own initialisers (seeded), BatchNorm affines drawn near
    identity, the head multiplied by HEAD_GAIN."""
    torch.manual_seed(seed)
    sd = {}

    def put(prefix, module):
        for k, v in module.state_dict().items():
            sd[f"{prefix}.{k}"] = v.detach().clone()

    def bn(prefix, module):
        with torch.no_grad():
            module.weight.uniform_(0.8, 1.2)
            module.bias.uniform_(-0.1, 0.1)
        put(prefix, module)

    for i, (kernel, stride, padding, c_in) in enumerate(CONVS):
        put(f"conv.seq_module.{3 * i}", nn.Conv2d(c_in, 32, kernel, stride, padding))
        bn(f"conv.seq_module.{3 * i + 1}", nn.BatchNorm2d(32))
    width = 32 * 41
    for k in range(LAYERS):
        if k > 0:
            bn(f"rnns.{k}.batch_norm.module", nn.BatchNorm1d(width))
        put(f"rnns.{k}.rnn", nn.LSTM(width, HIDDEN, bidirectional=True))
        width = HIDDEN
    bn("fc.0.module.0", nn.BatchNorm1d(HIDDEN))
    head = nn.Linear(HIDDEN, len(LABELS), bias=False)
    sd["fc.0.module.1.weight"] = head.weight.detach() * HEAD_GAIN
    return sd


@pytest.fixture(scope="module")
def state_dict():
    sd = module_state_dict()
    Reference(sd, CONFIG).calibrate(waves(7, (32000, 48000, 40000, 24000)))
    return sd


def package(sd: dict) -> dict:
    return {**CONFIG, "state_dict": sd}


def recognizer(sd: dict) -> Recognizer:
    model = DeepSpeechModel.load_model_package(package(sd))
    return Recognizer(model=model, device="cpu", compute_dtype="float32")


def port_logits(rec: Recognizer, batch: list) -> list:
    """The port's float32 logits of ``batch`` in one dispatch group, through
    the engine's staging, features and forward pass."""
    eng = rec.danspeech_recognizer
    plans = eng._plan_groups(batch)
    assert len(plans) == 1
    idxs, maxlen = plans[0]
    staged, lengths = eng._stage_group(batch, idxs, maxlen)
    parser = eng.audio_parser
    with torch.inference_mode():
        spect, frame_lens = stft_ops.batched_log_spectrogram(
            staged.float(), torch.from_numpy(lengths), parser.n_fft, parser.hop_length,
            eng._window, normalize=parser.normalize)
        logits, out_lens = ds.forward(eng._compute_params, eng.model.config, spect[:, None],
                                      frame_lens, softmax=False)
    got = [None] * len(batch)
    for j, i in enumerate(idxs):
        got[i] = logits[j, : int(out_lens[j])]
    return got


def worst_rel(got: list, ref: list) -> float:
    scale = max(float(r.abs().max()) for r in ref)
    return max(float((g - r).abs().max()) for g, r in zip(got, ref)) / scale


def test_published_layout_loads_contiguous(state_dict):
    assert state_dict["rnns.0.rnn.weight_hh_l0"].is_contiguous()
    params = params_from_state_dict(state_dict, config_from_package(package(state_dict)))
    for entry in params["rnns"]:
        for w in (entry["fwd"], entry["bwd"]):
            assert w.w_ih.shape == (w.w_ih.shape[0], 4 * HIDDEN) and w.w_ih.is_contiguous()
            assert w.w_hh.shape == (HIDDEN, 4 * HIDDEN) and w.w_hh.is_contiguous()


def test_port_logits_match_the_reference(state_dict):
    batch = waves(11)
    ref = Reference(state_dict, CONFIG).logits(batch)
    got = port_logits(recognizer(state_dict), batch)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
    assert worst_rel(got, ref) < LOGIT_RTOL


def test_reverse_chain_from_the_last_frame_fails_the_tolerance(state_dict, monkeypatch):
    """Every reverse chain started at the batch's last frame, as a walk
    that ignored the row's own length would: outside the tolerance."""
    batch = waves(11)
    ref = Reference(state_dict, CONFIG).logits(batch)
    plain = lstm_cuda.lstm_scan_plain

    def from_t_max(gx, lengths, w_hh, b_hh, h0, c0, reverse=False):
        if reverse:
            lengths = torch.full_like(lengths, gx.shape[0])
        return plain(gx, lengths, w_hh, b_hh, h0, c0, reverse)

    # the plain version the CPU runs for each chain (walks.run)
    monkeypatch.setattr(lstm_cuda, "LSTM_SCAN",
                        dataclasses.replace(lstm_cuda.LSTM_SCAN, plain=from_t_max))
    assert worst_rel(port_logits(recognizer(state_dict), batch), ref) > 10 * LOGIT_RTOL


def test_greedy_batch_equals_one_at_a_time(state_dict):
    rec = recognizer(state_dict)
    batch = waves(13)
    texts = rec.recognize_batch(batch)
    assert texts == [rec.recognize(w) for w in batch]
    # the sharpened head moves the greedy path over time
    assert len(set(texts)) == len(texts) and all(len(t) > 1 for t in texts)
    assert set("".join(texts)) <= set(LABELS[1:])


def transposed_views(sd: dict) -> dict:
    """The same values with every recurrent weight a transposed view of
    (I, G·H) storage, as the port's exporter writes them."""
    return {k: v.T.contiguous().T if ".rnn.weight_" in k else v for k, v in sd.items()}


@pytest.mark.parametrize("rnn_type,gates", [("gru", 3), ("lstm", 4)])
def test_contiguous_recurrent_weights_load_contiguous(rnn_type, gates):
    """A state dict as ``nn.GRU`` / ``nn.LSTM`` save it, and the same values
    as transposed views: both load as contiguous (I, G·H) and (H, G·H)
    weights with equal values."""
    config = config_from_package({**CONFIG, "rnn_type": rnn_type, "rnn_layers": 1})
    torch.manual_seed(1)
    rnn = (nn.GRU if rnn_type == "gru" else nn.LSTM)(32 * 41, HIDDEN, bidirectional=True)
    sd = {f"rnns.0.rnn.{k}": v.detach() for k, v in rnn.state_dict().items()}
    sd.update({k: v for k, v in module_state_dict().items()
               if k.startswith(("conv.", "fc."))})
    loaded = [params_from_state_dict(d, config)["rnns"][0] for d in (sd, transposed_views(sd))]
    for side in ("fwd", "bwd"):
        for name in ("w_ih", "w_hh"):
            a, b = (getattr(p[side], name) for p in loaded)
            assert a.is_contiguous() and b.is_contiguous()
            assert a.shape[1] == gates * HIDDEN and torch.equal(a, b)


def test_both_layouts_give_equal_transcripts(state_dict):
    batch = waves(17)
    assert (recognizer(state_dict).recognize_batch(batch)
            == recognizer(transposed_views(state_dict)).recognize_batch(batch))


def test_lstm_layer_spans():
    """Each LSTM layer's ``model.rnn`` holds one ``model.rnn.project`` and
    one ``model.rnn.walk``, in that order; the output is the same with and
    without a profiler."""
    model = DeepSpeechModel.load_model_package(package(module_state_dict(3)))
    x = torch.randn(2, 1, 161, 60)
    lengths = torch.tensor([60, 41])
    ref, _ = ds.forward(model.params, model.config, x, lengths)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, _ = ds.forward(model.params, model.config, x, lengths)
    assert torch.equal(out, ref)
    events = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                    if e.name.startswith("model.rnn"))
    names = Counter(n for _, _, n in events)
    assert names == {"model.rnn": LAYERS, "model.rnn.project": LAYERS,
                     "model.rnn.walk": LAYERS}
    for s, t, name in events:
        if name == "model.rnn":
            inner = [n for s2, t2, n in events if s <= s2 and t2 <= t and n != name]
            assert inner == ["model.rnn.project", "model.rnn.walk"]


def test_spans_off_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or contextlib.nullcontext())
    model = DeepSpeechModel.load_model_package(package(module_state_dict(3)))
    ds.forward(model.params, model.config, torch.randn(1, 1, 161, 30), torch.tensor([30]))
    assert opened == []
