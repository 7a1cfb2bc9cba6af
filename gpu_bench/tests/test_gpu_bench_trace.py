"""Reading a profiler trace: the busy time is the union of device intervals,
kernel groups by name or by the launching host operation, idle gaps named
by what the host was doing, and the per-layer readings over them."""

import pytest

import harness
from devtrace import Trace


def x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


EVENTS = [
    x("user_annotation", "bench.window", 1000, 1000),
    x("user_annotation", "bench.call", 1000, 500),
    x("user_annotation", "bench.call", 1600, 400),
    x("cpu_op", "aten::cudnn_convolution", 1000, 50, **{"External id": 7}),
    x("cpu_op", "aten::copy_", 1300, 300, **{"External id": 8}),
    x("cuda_runtime", "cudaEventSynchronize", 1350, 200),
    x("kernel", "void gru_persist_kernel<2>(Args)", 900, 300, **{"External id": 9}),
    x("kernel", "sm90_xmma_fprop_anything", 1150, 100, **{"External id": 7}),
    x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 1180, 40),
    x("kernel", "void gru_proj_wgmma_kernel<1>(...)", 1600, 200),
    x("kernel", "elementwise", 1950, 100),
]
B3 = {"match": ["gru_persist_kernel", "gru_proj_wgmma_kernel"], "launched_by": [],
      "work": ["rnn_projection", "rnn_recurrence"], "layers": "bidirectional"}
CONV = {"match": [], "launched_by": ["aten::cudnn_convolution"], "work": ["conv"]}


def test_window_busy_and_groups():
    t = Trace(EVENTS)
    assert t.window_s == pytest.approx(1e-3)
    # clipped to [1000, 2000]: [1000, 1250] (200 + 100 with the copy inside),
    # [1600, 1800], [1950, 2000]
    assert t.busy_s == pytest.approx(500e-6)
    assert t.group_s(B3) == pytest.approx(400e-6)
    assert t.group_s(CONV) == pytest.approx(100e-6)
    assert t.count("gru_persist_kernel") == 1
    assert t.top_ops(2)[0] == ["void gru_persist_kernel<2>(Args)", pytest.approx(200e-6)]


def test_idle_gaps_by_host():
    gaps = dict(Trace(EVENTS).idle_gaps())
    # 1250-1600: its middle 1425 lies in the first call, inside the sync
    assert gaps["bench.call: cudaEventSynchronize"] == pytest.approx(350e-6)
    # 1800-1950: its middle 1875 in the second call, with no host operation
    assert gaps["bench.call: host"] == pytest.approx(150e-6)
    assert sum(gaps.values()) == pytest.approx(500e-6)


RECORDS = [(0.0, 0.25, 0, True), (0.3, 0.4, 1, True), (0.5, 0.9, 1, False)]


def reading_of(config: dict, trace=None, **kw) -> harness.Reading:
    """Two answered calls of 2 and 6 audio seconds in a 0.9 s window."""
    args = dict(records=RECORDS, audio_s=[2.0, 6.0], frames=[10000, 30000],
                flops=[3e12, 5e12], setup_s=12.5, window_s=0.9, trace=trace,
                groups={"b3": B3, "conv": CONV})
    return harness.Reading(config, **{**args, **kw})


def test_readings_over_the_trace():
    config = harness.cell_parts(harness.benchmark(), "primary-batch")[1]
    reading = reading_of(config, Trace(EVENTS))
    assert reading.call_p50_ms() == pytest.approx(175.0)
    assert reading.idle_pct() == pytest.approx(50.0)
    assert reading.ms_per_audio_s("conv") == pytest.approx(0.1 / 8.0)
    # bound by the operations at these frame counts: 2 directions of (D + H) x 3H
    flops = sum(2 * 2 * (d + 1200) * 3600 for d in [2016] + [1200] * 8)
    assert reading.roofline_pct("b3") == pytest.approx(100 * flops * 40000 / 989e12 / 400e-6)
    # 8e12 operations over the traced millisecond at 989 TFLOP/s
    assert reading.mfu_pct() == pytest.approx(100 * 8e12 / (1e-3 * 989e12))
    uni = dict(config, bidirectional=False)
    assert reading_of(uni, Trace(EVENTS)).roofline_pct("b3") is None


# the 95th percentile of the two answered calls (250 and 100 ms), linear
@pytest.mark.parametrize("metric,value", [
    ("setup_s", 12.5), ("batch_audio_s_per_s", 8.0 / 0.9),
    ("recognize_p95_ms", 100.0 + 0.95 * 150.0), ("call_p50_ms.batch", 175.0),
    ("call_p50_ms.recognize", 175.0), ("idle_pct.batch", 50.0),
    ("mfu_pct.recognize", 100 * 8e12 / (1e-3 * 989e12))])
def test_readers_by_name(metric, value):
    """Each metric's reader is found by its name, or by the part before the
    first dot, and reads the window's records and work."""
    config = harness.cell_parts(harness.benchmark(), "primary-batch")[1]
    assert harness.reader(metric)(reading_of(config, Trace(EVENTS))) == pytest.approx(value)


def test_every_metric_has_a_reader():
    bench = harness.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"]))
    assert harness.reader_path("mfu_pct.anything").endswith("metrics/mfu_pct.py")
    with pytest.raises(FileNotFoundError):
        harness.reader_path("no_such_metric.batch")


def test_kernel_groups_on_disk():
    groups = harness.kernel_groups()
    assert {"b1", "b3", "conv"} <= set(groups)
    for g in groups.values():
        assert g["match"] or g["launched_by"]
        for c in g["launch_check"]:
            assert any(c["kernel"] in m for m in g["match"])
