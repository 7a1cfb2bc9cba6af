"""The readers of the program's own spans (``spans.py``): per-call sums of
``engine.*`` spans inside each ``bench.call``, the share of the engine's
time spent waiting, and the device idle time no ``engine.``/``model.`` span
covers, on hand-made traces."""

from types import SimpleNamespace

import pytest

import harness
from devtrace import Trace


def x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def span(name, start, end):
    return x("user_annotation", name, start, end - start)


EVENTS = [
    span("bench.window", 0, 10000),
    # call A: greedy, 800 us of host work, 1100 us of enqueue, 1400 us waiting
    span("bench.call", 100, 4000),
    span("engine.call", 200, 3800),
    span("engine.plan", 200, 300),
    span("engine.stage", 300, 500),
    span("engine.upload", 500, 550),
    span("engine.forward", 550, 1500),
    span("model.rnn", 600, 1400),
    span("engine.d2h", 1500, 1600),
    span("engine.wait", 1600, 3000),
    span("engine.collapse", 3000, 3500),
    # call B: a beam decode, 1400 us of host work, 500 us of enqueue, 1900 us waiting
    span("bench.call", 5000, 9000),
    span("engine.call", 5100, 8900),
    span("engine.plan", 5100, 5200),
    span("engine.stage", 5200, 5600),
    span("engine.upload", 5600, 5700),
    span("engine.forward", 5700, 6000),
    span("model.conv", 5700, 5800),
    span("model.rnn", 5800, 5950),
    span("engine.d2h", 6000, 6100),
    span("engine.wait", 6100, 8000),
    span("engine.decode", 8000, 8900),
    # outside every call: in no call's sums
    span("engine.stage", 9300, 9400),
    x("cpu_op", "aten::copy_", 9250, 10),
    # busy [0, 250], [600, 2800], [5800, 7900], [9000, 9200] of the window
    x("kernel", "gru_persist_kernel", -50, 300),
    x("kernel", "gru_persist_kernel", 600, 2000),
    x("gpu_memcpy", "Memcpy HtoD", 2500, 300),
    x("kernel", "gru_persist_kernel", 5800, 2100),
    x("kernel", "elementwise", 9000, 200),
]

# idle [250, 600], [2800, 5800], [7900, 9000], [9200, 10000]: 5250 us, of
# which the engine.call spans cover 350 + 1000 + 700 + 1000 and the stray
# engine.stage 100: an open span names idle time inside a call or not
UNSPANNED = 100.0 * (5250 - 3150) / 5250


def read(metric, events):
    return harness.reader(metric)(SimpleNamespace(trace=Trace(events)))


@pytest.mark.parametrize("metric,value", [
    ("engine_host_ms.batch", (0.8 + 1.4) / 2), ("engine_host_ms.recognize", (0.8 + 1.4) / 2),
    ("enqueue_ms.batch", (1.1 + 0.5) / 2), ("enqueue_ms.recognize", (1.1 + 0.5) / 2),
    ("wait_pct.batch", 100.0 * 3300 / 7400), ("wait_pct.recognize", 100.0 * 3300 / 7400),
    ("idle_unspanned_pct.batch", UNSPANNED), ("idle_unspanned_pct.recognize", UNSPANNED)])
def test_span_readers(metric, value):
    assert read(metric, EVENTS) == pytest.approx(value)


NO_PROGRAM = [e for e in EVENTS if not e["name"].startswith(("engine.", "model."))]


@pytest.mark.parametrize("metric", ["engine_host_ms.batch", "enqueue_ms.recognize",
                                    "wait_pct.batch", "idle_unspanned_pct.recognize"])
def test_no_engine_call_reads_none(metric):
    """The parent's trace: the program opens no span."""
    assert read(metric, NO_PROGRAM) is None
    # model spans alone (a forward pass outside the engine) are no engine call
    assert read(metric, NO_PROGRAM + [span("model.rnn", 600, 1400)]) is None


def test_gap_under_a_span_opened_long_before():
    """A gap whose only open span started more than 400 host events
    earlier: the breakdown's look-back cannot name it, the intervals can."""
    ops = [x("cpu_op", "aten::add", 20 + 2 * i, 1) for i in range(500)]
    events = [span("bench.window", 0, 2000), span("bench.call", 0, 2000),
              span("engine.call", 10, 1990), *ops,
              x("kernel", "gru_persist_kernel", 0, 1100),
              x("kernel", "gru_persist_kernel", 1500, 500)]
    gaps = dict(Trace(events).idle_gaps())
    assert gaps == {"bench.call: host": pytest.approx(400e-6)}
    assert read("idle_unspanned_pct.batch", events) == pytest.approx(0.0)
    # the same gap with the engine's span gone is all unnamed
    bare = [e for e in events if e["name"] != "engine.call"] + [span("engine.call", 1995, 1999)]
    assert read("idle_unspanned_pct.batch", bare) == pytest.approx(100.0)
