"""Reading a ``torch.profiler`` trace of the measured window.

The run records its own spans with ``record_function``: ``bench.window``
around the whole window and ``bench.call`` around each call into the
program. The trace is exported as Chrome trace JSON and read here:

- device operations: kernels, copies and fills on the card (``kernel``,
  ``gpu_memcpy``, ``gpu_memset``), clipped to the window;
- the device's busy time: the union of their intervals, so operations that
  overlap (an asynchronous copy beside a kernel) count once;
- kernel groups (``kernels/<file>.json``): a kernel belongs to a group when
  its name holds one of the group's ``match`` substrings or the host
  operation that launched it is one of its ``launched_by`` names;
- idle gaps, each named by the span and the innermost host operation open
  at its middle.
"""

from __future__ import annotations

import bisect
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class Trace:
    def __init__(self, events: list):
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith("bench.")]
        windows = [e for e in spans if e["name"] == "bench.window"]
        if len(windows) != 1:
            raise RuntimeError(f"the trace holds {len(windows)} bench.window spans, not 1")
        self.start = float(windows[0]["ts"])
        self.end = self.start + float(windows[0]["dur"])
        self.calls = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                            for e in spans if e["name"] == "bench.call")
        host = [e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"]
        self.host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                           for e in host)
        self.host_starts = [h[0] for h in self.host]
        launcher = {}
        for e in events:
            if e.get("cat") == "cpu_op" and "External id" in e.get("args", {}):
                launcher[e["args"]["External id"]] = e["name"]
        self.device = []  # (start us, end us, name, launching host op or None)
        for e in events:
            if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
                continue
            s = max(float(e["ts"]), self.start)
            t = min(float(e["ts"]) + float(e.get("dur", 0)), self.end)
            if t > s:
                ext = e.get("args", {}).get("External id")
                self.device.append((s, t, e["name"], launcher.get(ext)))
        self.device.sort()

    @classmethod
    def from_file(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_intervals(self) -> list:
        merged = []
        for s, t, _, _ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) / 1e6

    def kernels_of(self, group: dict) -> list:
        """The device events of a kernel group."""
        match, launched = group.get("match", []), group.get("launched_by", [])
        return [e for e in self.device
                if any(m in e[2] for m in match) or (e[3] is not None and e[3] in launched)]

    def group_s(self, group: dict) -> float:
        return sum(t - s for s, t, _, _ in self.kernels_of(group)) / 1e6

    def count(self, substring: str) -> int:
        return sum(substring in name for _, _, name, _ in self.device)

    def top_ops(self, n: int = 10) -> list:
        by_name: dict = {}
        for s, t, name, _ in self.device:
            by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e6
        return sorted(([k[:160], v] for k, v in by_name.items()), key=lambda r: -r[1])[:n]

    def _host_at(self, ts: float) -> str:
        """The innermost host operation open at ``ts``, or "host"."""
        i = bisect.bisect_right(self.host_starts, ts) - 1
        for j in range(i, max(i - 400, -1), -1):
            s, t, name = self.host[j]
            if t >= ts and not name.startswith("bench."):
                return name
        return "host"

    def _span_at(self, ts: float) -> str:
        i = bisect.bisect_right(self.calls, (ts, float("inf"))) - 1
        return "bench.call" if i >= 0 and self.calls[i][1] >= ts else "between calls"

    def idle_gaps(self, n: int = 10) -> list:
        """Idle time of the window by what the host was doing: [name,
        seconds] of the ``n`` names with the most idle time."""
        gaps, at = [], self.start
        for s, t in self.busy_intervals() + [[self.end, self.end]]:
            if s > at:
                gaps.append((at, s))
            at = max(at, t)
        by_name: dict = {}
        for s, t in gaps:
            mid = (s + t) / 2
            name = f"{self._span_at(mid)}: {self._host_at(mid)}"
            by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e6
        return sorted(([k, v] for k, v in by_name.items()), key=lambda r: -r[1])[:n]
