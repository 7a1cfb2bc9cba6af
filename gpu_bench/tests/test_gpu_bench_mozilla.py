"""The Mozilla DeepSpeech cell (``mozilla-ds-batch``) on the CPU at a tiny
size: the frames and operations against hand counts, the weights in the
release's TensorFlow layout, the reference against the port and loading
nothing of it, the control failing the limit, a whole run sound and with each
fault the cell can have (``correct`` false), the two per-layer readers and the
step kernel's launch counter."""

import numpy as np
import pytest
import torch

import counters
import harness
import mixes
import mozilla_serving
import mozilla_work
from reference.mozilla_ref import LSTM_SCOPE
from reference.mozilla_ref import Model as Reference
from test_gpu_bench_imports import top_level_modules
from test_gpu_bench_lstm import kernel, span

CELL = "mozilla-ds-batch"
SEED = 2**31 + 41


def tiny(**kw):
    _, config, mix = harness.cell_parts(harness.benchmark(), CELL)
    config = dict(config, **{"rnn_hidden_size": 64, **kw})
    return config, dict(mix, calls=3, rows_per_call=4, min_s=0.5, max_s=2.0, check_requests=6)


def test_frames_and_flops_by_hand():
    assert [mozilla_work.utterance_frames(n) for n in (0, 511, 512, 831, 832, 16000)] == \
        [0, 0, 1, 1, 2, 49]
    config = harness.cell_parts(harness.benchmark(), CELL)[1]
    # 494 x 2048, three 2048 x 2048, 2048 x 29, and the LSTM's 4096 x 8192
    assert mozilla_work.model_flops_per_frame(config) == 94_416_896
    # 4.72 GFLOP an audio second at 50 frames a second
    assert mozilla_work.model_flops_per_frame(config) * 50 / 1e9 == pytest.approx(4.72, abs=0.01)
    flops, nbytes = mozilla_work.walk_work(config, 10)
    h = 2048
    assert flops == 2 * h * 4 * h * 10
    # gx read and the output written a frame in bf16, w_hh (bf16) and the
    # f32 bias once
    assert nbytes == 10 * (4 * h + h) * 2 + h * 4 * h * 2 + 4 * h * 4


def test_driver_counts_frames_and_operations_from_the_audio():
    config, mix = tiny()
    from driver import load

    d = load(mix["driver"]).__new__(load(mix["driver"]))
    d.config, d.mix = config, mix
    entry = [np.zeros(n, np.int16) for n in (16000, 500, 32000)]
    assert d.frames(entry) == 49 + 0 + 99
    assert d.flops(entry) == mozilla_work.model_flops_per_frame(config) * 148
    assert d.audio_s(entry) == pytest.approx(48500 / 16000)


def test_weights_in_the_release_layout():
    config = harness.cell_parts(harness.benchmark(), CELL)[1]
    config = dict(config, rnn_hidden_size=32)
    sd = mozilla_serving.state_dict(config, SEED, "cpu")
    assert sd[f"{LSTM_SCOPE}/kernel"].shape == (64, 128)
    assert sd[f"{LSTM_SCOPE}/bias"].shape == (128,)
    assert sd["layer_1/weights"].shape == (494, 32) and sd["layer_6/weights"].shape == (32, 29)
    for key, v in sd.items():
        if key.endswith("bias"):
            assert not v.any()
        else:
            fan_in, fan_out = v.shape
            bound = (6.0 / (fan_in + fan_out)) ** 0.5
            assert 0.9 * bound < float(v.abs().max()) <= bound * (1 + 1e-6)
    again = mozilla_serving.state_dict(config, SEED, "cpu")
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_reference_loads_nothing_of_the_program():
    loaded = top_level_modules("import reference.mozilla_ref, mozilla_work, counters")
    assert not loaded & {"danspeech_tpu_torch", "danspeech_tpu", "jax", "jaxlib", "flax"}


def test_reference_matches_the_port():
    from danspeech_tpu_torch import Recognizer
    from danspeech_tpu_torch.models import DeepSpeechModel

    import check

    config, mix = tiny()
    sd = mozilla_serving.state_dict(config, SEED, "cpu")
    rec = Recognizer(model=DeepSpeechModel.load_model_package(
        mozilla_serving.package(config, sd)), device="cpu")
    waves = mixes.pool(mix, SEED, "cpu")[0]
    eng = rec.danspeech_recognizer
    idxs, maxlen = eng._plan_groups(waves)[0]
    staged, lengths = eng._stage_group(waves, idxs, maxlen)
    probs, out_lens = eng._forward(eng._compute_params, staged, torch.from_numpy(lengths))
    ref = Reference(sd, config).logits([waves[i] for i in idxs])
    for j, logits in enumerate(ref):
        n = int(out_lens[j])
        assert logits.shape == (n, 29) and n == mozilla_work.utterance_frames(len(waves[idxs[j]]))
        want = torch.softmax(logits.double(), dim=-1)
        assert float((probs[j, :n].double() - want).abs().max()) < 1e-5
    texts = rec.recognize_batch(waves)
    for i, logits in zip(idxs, ref):
        assert check.text_gap(logits.numpy(), texts[i], config["labels"], 28) == 0.0
    # the greedy paths change over time at the release's initialisers
    assert all(len(set(texts[i])) > 2 for i in idxs)


def test_control_comes_out_not_correct():
    """The reference with every bf16 product taken in fp8, in the program's
    place, fails the cell's limit at a size a test run holds."""
    import check

    config, _ = tiny(rnn_hidden_size=256)
    mix = dict(harness.cell_parts(harness.benchmark(), CELL)[2], calls=1, rows_per_call=4,
               min_s=4.0, max_s=8.0)
    sd = mozilla_serving.state_dict(config, SEED, "cpu")
    waves = mixes.pool(mix, SEED, "cpu")[0]
    exact = Reference(sd, config).logits(waves)
    low = Reference(sd, config, control=True).logits(waves)
    labels = config["labels"]
    gaps = [check.text_gap(e.numpy(), check.greedy_text(c.numpy(), labels, 28), labels, 28)
            for e, c in zip(exact, low)]
    assert max(gaps) > config["limits"]["max_logit_gap"]


def run(**kw):
    config, mix = tiny(**kw)
    return harness.run_cell(CELL, SEED, 0.5, False, device="cpu", config=config, mix=mix)


def test_sound_run_is_correct():
    result = run()
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert result["compared"]["max_logit_gap"]["value"] == 0.0
    assert set(result["metrics"]) == {"batch_audio_s_per_s", "setup_s"}


def clip_binds(monkeypatch):
    """``layer_1`` drawn 40 times wider, in the program's weights and the
    reference's alike: a share of its outputs reach the clip at 20."""
    layout = mozilla_serving.layout

    def wide(config):
        return [(k, s, a * 40.0 if k == "layer_1/weights" else a) for k, s, a in layout(config)]

    monkeypatch.setattr(mozilla_serving, "layout", wide)


def no_clip(monkeypatch):
    from danspeech_tpu_torch.models import mozilla

    clip_binds(monkeypatch)
    monkeypatch.setattr(mozilla, "RELU_CLIP", float("inf"))


def gates_unreordered(monkeypatch):
    """The loader takes TensorFlow's i, c~, f, o as the port's i, f, g, o."""
    from danspeech_tpu_torch.models import mozilla

    monkeypatch.setattr(mozilla, "reorder_gates", lambda t, hidden: t)


def windows_shifted(monkeypatch):
    """Frame t's window centred on frame t - 1."""
    from danspeech_tpu_torch.models import mozilla

    windows = mozilla.windows
    monkeypatch.setattr(mozilla, "windows", lambda f: torch.roll(windows(f), 1, dims=0))


def blank_first(monkeypatch):
    """The decoder takes index 0 (the space) for the blank."""
    from danspeech_tpu_torch.engine import DanSpeechRecognizer

    build = DanSpeechRecognizer._build_decoder

    def first(self):
        decoder = build(self)
        decoder.blank_index = 0
        return decoder

    monkeypatch.setattr(DanSpeechRecognizer, "_build_decoder", first)


def test_sound_run_is_correct_where_the_clip_binds(monkeypatch):
    clip_binds(monkeypatch)
    result = run()
    assert result["correct"] and result["compared"]["max_logit_gap"]["value"] == 0.0


@pytest.mark.parametrize("fault", [no_clip, gates_unreordered, windows_shifted, blank_first])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = run()
    assert not result["correct"]
    gap = result["compared"]["max_logit_gap"]
    assert gap["value"] > gap["limit"] or not np.isfinite(gap["value"])


# two calls, the first's front end 100 + 20 us, the second's 300 + 50 us; the
# step kernel busy 200 + 500 us of the millisecond window
TRACED = [
    span("bench.window", 0, 1000),
    span("bench.call", 0, 450), span("engine.call", 10, 440),
    span("model.features", 20, 120), span("model.context", 120, 140),
    span("bench.call", 500, 1000), span("engine.call", 510, 990),
    span("model.features", 520, 820), span("model.context", 820, 870),
    kernel("lstm_step_kernel(bf16 const*)", 100, 300),
    kernel("lstm_step_kernel(bf16 const*)", 500, 1000),
]


def traced_reading(config, events):
    from devtrace import Trace

    records = [(0.0, 0.45, 0, True), (0.5, 1.0, 1, True)]
    return harness.Reading(config, records, [10.0, 20.0], [500, 1000], [1e12, 2e12], 10.0,
                           1.0, Trace(events), harness.kernel_groups())


def test_walk_roofline_and_front_end_readers():
    config = harness.cell_parts(harness.benchmark(), CELL)[1]
    reading = traced_reading(config, TRACED)
    bound = sum(mozilla_work.walk_bound_s(config, f) for f in (500, 1000))
    assert harness.reader("mds_walk_roofline.batch")(reading) == pytest.approx(100 * bound / 7e-4)
    # the median of 120 and 350 us
    assert harness.reader("mds_frontend.batch")(reading) == pytest.approx(0.235)


def test_readers_find_nothing_on_another_model():
    """A DeepSpeech2 model's trace: no context windows, and its B5 time is
    not this model's walk."""
    config = harness.cell_parts(harness.benchmark(), "librispeech-lstm-batch")[1]
    events = [e for e in TRACED if e["name"] != "model.context"]
    reading = traced_reading(config, events)
    assert harness.reader("mds_walk_roofline.batch")(reading) is None
    assert harness.reader("mds_frontend.batch")(reading) is None


def test_step_launch_check_reads_the_program_or_nothing(monkeypatch):
    """The launch check of ``kernels/b5_step.json`` reads the program's
    ``lstm_step_launches``; a program without it reads 0."""
    from danspeech_tpu_torch.ops import lstm_cuda

    check = next(c for c in harness.kernel_groups()["b5"]["launch_check"]
                 if c["kernel"] == "lstm_step_kernel")
    proxy = harness.counter(check["counter"])
    assert proxy is counters.step_launches
    assert proxy.design_counts is lstm_cuda.lstm_step_launches.design_counts
    monkeypatch.delattr(lstm_cuda, "lstm_step_launches")
    assert proxy.design_counts[check["design"]] == 0
