"""The program's own spans in the traced window.

The port marks its steps with ``record_function`` while a profiler records
(``danspeech_tpu_torch/utils/profiling.py:annotate``): ``engine.*`` in the
engine's batch call, ``engine.call`` the root of each, and ``model.*`` in
the forward pass. They are host events of the trace (``user_annotation``,
``Trace.host``) on the device's clock. A window with no ``engine.call`` is
a program without them: the readers over this module then read None.
"""

from __future__ import annotations

import bisect

PROGRAM = ("engine.", "model.")


def in_calls(trace, names) -> dict:
    """{name: [[(start us, end us), ...] for each ``bench.call``]}: the spans
    of each of ``names`` lying inside each call of the window."""
    starts = [s for s, _ in trace.calls]
    got = {n: [[] for _ in trace.calls] for n in names}
    for s, t, name in trace.host:
        if name in got:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and t <= trace.calls[i][1]:
                got[name][i].append((s, t))
    return got


def call_ms(trace, names) -> list:
    """The summed ms of the spans of ``names`` in each ``bench.call`` that
    holds an ``engine.call``; empty where none does."""
    got = in_calls(trace, set(names) | {"engine.call"})
    return [sum(t - s for n in names for s, t in got[n][i]) / 1e3
            for i, roots in enumerate(got["engine.call"]) if roots]


def total_ms(trace, name) -> float:
    """The summed ms of the spans of ``name`` inside the window's calls."""
    return sum(t - s for spans in in_calls(trace, [name])[name] for s, t in spans) / 1e3


def _merged(intervals) -> list:
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _overlap_us(a: list, b: list) -> float:
    """The length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_unspanned_pct(trace, prefixes=PROGRAM):
    """Device idle time of the window with no span of ``prefixes`` open,
    over all its device idle time, in %; None where the window holds no
    ``engine.call``. Intervals, not the innermost host event: a gap under a
    span opened long before counts as under it."""
    spans = [(max(s, trace.start), min(t, trace.end)) for s, t, name in trace.host
             if name.startswith(prefixes) and t > trace.start and s < trace.end]
    if not any(name == "engine.call" and trace.start <= s and t <= trace.end
               for s, t, name in trace.host):
        return None
    gaps, at = [], trace.start
    for s, t in trace.busy_intervals() + [[trace.end, trace.end]]:
        if s > at:
            gaps.append([at, s])
        at = max(at, t)
    idle = sum(t - s for s, t in gaps)
    if idle == 0:
        return 0.0
    return 100.0 * (idle - _overlap_us(gaps, _merged(spans))) / idle
