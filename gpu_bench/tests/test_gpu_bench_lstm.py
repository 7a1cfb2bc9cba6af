"""The LSTM cell (``librispeech-lstm-batch``) on the CPU at a tiny size: the
work counted for four gates against hand counts, the LSTM reference against
the port and loading nothing of it, the control failing the limit, the
weights in ``nn.LSTM``'s layout, and a whole run sound and with each fault
the cell can have: ``correct`` false."""

import numpy as np
import pytest
import torch

import check
import harness
import lstm_serving
import lstm_work
import mixes
import weights
import work
from reference.lstm_ref import Model as Reference
from test_gpu_bench_imports import top_level_modules

CELL = "librispeech-lstm-batch"
SEED = 2**31 + 29
SMALL = {"rnn_type": "lstm", "rnn_hidden_size": 8, "rnn_layers": 2, "conv_layers": 2,
         "bidirectional": True, "context": 20, "labels": "_ab", "compute_dtype": "auto",
         "audio_conf": {"sampling_rate": 16000, "window_size": 0.02, "window_stride": 0.01}}


def tiny(**kw):
    _, config, mix = harness.cell_parts(harness.benchmark(), CELL)
    config = dict(config, **{"rnn_hidden_size": 32, "rnn_layers": 2, **kw})
    return config, dict(mix, calls=3, rows_per_call=4, min_s=0.5, max_s=2.0, check_requests=6)


def made(config: dict) -> dict:
    sd = lstm_serving.state_dict(config, SEED, "cpu")
    lstm_serving.calibrate(sd, config, SEED, "cpu")
    return sd


def test_model_flops_by_hand():
    d, h = 32 * 41, 8
    convs = 2 * 41 * 11 * 1 * 32 * 81 + 2 * 21 * 11 * 32 * 32 * 41
    lstm = 2 * 2 * (d + h) * 4 * h + 2 * 2 * (h + h) * 4 * h
    assert lstm_work.model_flops_per_frame(SMALL) == convs + lstm + 2 * h * 3


def test_published_widths_by_hand():
    ds2 = dict(SMALL, rnn_hidden_size=1024, rnn_layers=5, labels="_" * 29)
    # GFLOP an audio second at 50 frames a second: LSTM 8.63 + convs 1.09
    assert lstm_work.model_flops_per_frame(ds2) * 50 / 1e9 == pytest.approx(9.72, abs=0.01)
    # B5 a frame: 5 layers x 2 directions x 2 H 4H
    flops, _ = lstm_work.recurrence_work(ds2, 1)
    assert flops == 5 * 2 * 2 * 1024 * 4096


def test_recurrence_counts_by_hand():
    h, frames = 8, 10
    flops, nbytes = lstm_work.recurrence_work(SMALL, frames)
    assert flops == 2 * 2 * (2 * h * 4 * h * frames)
    # per layer and direction: gx read and the output written a frame, w_hh
    # and b_hh once
    assert nbytes == 2 * 2 * (frames * (4 * h + h) * 2 + h * 4 * h * 2 + 4 * h * 4)
    assert lstm_work.recurrence_bound_s(SMALL, frames) == work.bound_s(flops, nbytes, SMALL)


def test_weights_in_nn_lstm_layout():
    config, _ = tiny()
    sd = lstm_serving.state_dict(config, SEED, "cpu")
    ref = torch.nn.LSTM(32 * 41, 32, bidirectional=True).state_dict()
    for k, v in ref.items():
        got = sd[f"rnns.0.rnn.{k}"]
        assert got.shape == v.shape and got.is_contiguous()
    assert sd["rnns.1.rnn.weight_ih_l0_reverse"].shape == (4 * 32, 32)
    assert torch.equal(sd["rnns.0.rnn.weight_hh_l0"],
                       lstm_serving.state_dict(config, SEED, "cpu")["rnns.0.rnn.weight_hh_l0"])


def test_reference_loads_nothing_of_the_program():
    loaded = top_level_modules("import reference.lstm_ref, lstm_work")
    assert not loaded & {"danspeech_tpu_torch", "danspeech_tpu", "jax", "jaxlib", "flax"}


def test_reference_matches_the_port():
    from danspeech_tpu_torch import Recognizer
    from danspeech_tpu_torch.models import DeepSpeechModel

    config, mix = tiny()
    sd = made(config)
    model = DeepSpeechModel.load_model_package(weights.package(config, sd))
    rec = Recognizer(model=model, device="cpu")
    waves = mixes.pool(mix, SEED, "cpu")[0]
    eng = rec.danspeech_recognizer
    idxs, maxlen = eng._plan_groups(waves)[0]
    staged, lengths = eng._stage_group(waves, idxs, maxlen)
    probs, out_lens = eng._forward(eng._compute_params, staged, torch.from_numpy(lengths))
    ref = Reference(sd, config).logits([waves[i] for i in idxs])
    for j, logits in enumerate(ref):
        n = int(out_lens[j])
        assert logits.shape == (n, len(config["labels"]))
        # float32 on both sides, summed in other orders; the sharpened head's
        # logits reach about 100, so their rounding moves probabilities by
        # about 1e-4 near a tie
        want = torch.softmax(logits.double(), dim=-1)
        assert float((probs[j, :n].double() - want).abs().max()) < 1e-3
    texts = rec.recognize_batch(waves)
    for i, logits in zip(idxs, ref):
        assert check.text_gap(logits.numpy(), texts[i], config["labels"]) == 0.0
    # the greedy paths change over time
    assert all(len(texts[i]) > 1 for i in idxs)


def test_control_comes_out_not_correct():
    """The reference with every bf16 product taken in fp8, in the program's
    place, fails the cell's limit at a size a test run holds."""
    config, _ = tiny(rnn_hidden_size=256)
    mix = dict(harness.cell_parts(harness.benchmark(), CELL)[2], calls=1, rows_per_call=4,
               min_s=3.0, max_s=6.0)
    sd = made(config)
    waves = mixes.pool(mix, SEED, "cpu")[0]
    exact = Reference(sd, config).logits(waves)
    low = Reference(sd, config, control=True).logits(waves)
    labels = config["labels"]
    gaps = [check.text_gap(e.numpy(), check.greedy_text(c.numpy(), labels), labels)
            for e, c in zip(exact, low)]
    assert max(gaps) > config["limits"]["max_logit_gap"]


def run():
    config, mix = tiny()
    return harness.run_cell(CELL, SEED, 0.5, False, device="cpu", config=config, mix=mix)


def cell_unchanged(monkeypatch):
    """The cell state is never updated: the forget gate reads 1 and the
    input gate 0 in every LSTM walk, so c keeps c0."""
    from danspeech_tpu_torch.ops import lstm_cuda

    gates = lstm_cuda._gates

    def held(pre, hidden):
        i, f, g, o = gates(pre, hidden)
        return torch.zeros_like(i), torch.ones_like(f), g, o

    monkeypatch.setattr(lstm_cuda, "_gates", held)


def gates_swapped(monkeypatch):
    """The forget and input gates swapped in every LSTM walk."""
    from danspeech_tpu_torch.ops import lstm_cuda

    gates = lstm_cuda._gates

    def swapped(pre, hidden):
        i, f, g, o = gates(pre, hidden)
        return f, i, g, o

    monkeypatch.setattr(lstm_cuda, "_gates", swapped)


def half_left_out(monkeypatch):
    """The second half of every dispatch group's rows is never computed: its
    paths stay blank."""
    from danspeech_tpu_torch.engine import DanSpeechRecognizer

    forward = DanSpeechRecognizer._forward_greedy

    def first_half(self, params, waveforms, lengths):
        ids, out_lens = forward(self, params, waveforms, lengths)
        ids = ids.clone()
        ids[max(1, ids.shape[0] // 2):] = 0
        return ids, out_lens

    monkeypatch.setattr(DanSpeechRecognizer, "_forward_greedy", first_half)


def test_sound_run_is_correct():
    result = run()
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert result["compared"]["max_logit_gap"]["value"] == 0.0
    assert set(result["metrics"]) == {"batch_audio_s_per_s", "setup_s"}


@pytest.mark.parametrize("fault", [cell_unchanged, gates_swapped, half_left_out])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = run()
    assert not result["correct"]
    gap = result["compared"]["max_logit_gap"]
    assert gap["value"] > gap["limit"] or not np.isfinite(gap["value"])


def span(name, start, end):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": start,
            "dur": end - start, "args": {}}


def kernel(name, start, end):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": start, "dur": end - start,
            "args": {}}


# two calls; the first's two layers project for 100 + 150 us, the second's
# one layer for 300 us; B5 busy 400 + 600 us of the millisecond window
TRACED = [
    span("bench.window", 0, 1000),
    span("bench.call", 0, 450), span("engine.call", 10, 440),
    span("model.rnn", 20, 200), span("model.rnn.project", 20, 120),
    span("model.rnn", 200, 400), span("model.rnn.project", 200, 350),
    span("bench.call", 500, 1000), span("engine.call", 510, 990),
    span("model.rnn", 520, 900), span("model.rnn.project", 520, 820),
    kernel("void lstm_persist_kernel<2>(Args)", 0, 400),
    kernel("void lstm_persist_kernel<2>(Args)", 400, 1000),
    kernel("void lstm_bwd_persist_kernel<2>(Args)", 400, 1000),
]


def traced_reading(config, events):
    from devtrace import Trace

    records = [(0.0, 0.45, 0, True), (0.5, 1.0, 1, True)]
    return harness.Reading(config, records, [10.0, 20.0], [500, 1000], [1e12, 2e12], 10.0,
                           1.0, Trace(events), harness.kernel_groups())


def test_b5_and_projection_readers():
    config = harness.cell_parts(harness.benchmark(), CELL)[1]
    reading = traced_reading(config, TRACED)
    assert reading.trace.count("lstm_persist_kernel") == 2
    bound = sum(lstm_work.recurrence_bound_s(config, f) for f in (500, 1000))
    assert harness.reader("b5_roofline.batch")(reading) == pytest.approx(100 * bound / 1e-3)
    # the median of 250 and 300 us
    assert harness.reader("lstm_project_host_ms.batch")(reading) == pytest.approx(0.275)


def test_b5_and_projection_readers_find_nothing_on_a_gru_trace():
    """A GRU model's trace (or a program without the LSTM spans): None."""
    config = harness.cell_parts(harness.benchmark(), "primary-batch")[1]
    gru = [e for e in TRACED if "lstm" not in e["name"] and e["name"] != "model.rnn.project"]
    reading = traced_reading(config, gru)
    assert harness.reader("b5_roofline.batch")(reading) is None
    assert harness.reader("lstm_project_host_ms.batch")(reading) is None
