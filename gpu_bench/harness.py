"""One run of one cell: set-up, the measured window, the reading of its
metrics, and the comparison that decides ``correct``.

Everything is found by name from ``BENCHMARK.json``: a cell's configuration
in ``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``,
the mix's driver in ``drivers/<driver>.py`` (``driver.py``: what the
window calls, the work of each call, the comparison), each metric's reader
in ``metrics/<metric>.py`` or, where that file is absent, in
``metrics/<stem>.py`` for the part of the metric's name before its first
dot (a function ``read(reading)`` returning a number, or None where it
finds nothing to read), and the kernel groups in ``kernels/*.json`` (every
file naming a group adds to it).
"""

from __future__ import annotations

import contextlib
import gc
import glob
import importlib
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time

import torch

import driver
import work
from devtrace import Trace

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "danspeech_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_parts(bench: dict, name: str) -> tuple:
    """(cell, configuration, traffic mix) of the workload ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    config = load_json(os.path.join(BENCH_DIR, "configs", f"{cell['config']}.json"))
    mix = load_json(os.path.join(BENCH_DIR, "traffic", f"{cell['traffic']}.json"))
    return cell, config, mix


def metrics_of(bench: dict, kind: str, cell: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def kernel_groups() -> dict:
    """{group: {"match", "launched_by", "work", "layers", "launch_check"}},
    the union of every ``kernels/*.json`` naming a group."""
    groups: dict = {}
    for path in sorted(glob.glob(os.path.join(BENCH_DIR, "kernels", "*.json"))):
        spec = load_json(path)
        g = groups.setdefault(spec["group"], {"match": [], "launched_by": [],
                                              "launch_check": []})
        for key in ("match", "launched_by", "launch_check"):
            g[key] += spec.get(key, [])
        for key in ("work", "layers"):
            if key in spec:
                if g.get(key, spec[key]) != spec[key]:
                    raise ValueError(f"kernel group {spec['group']}: {path} gives another {key}")
                g[key] = spec[key]
    return groups


def reader_path(name: str) -> str:
    """``metrics/<name>.py``, or ``metrics/<stem>.py`` for the part of the
    name before its first dot where the first is absent."""
    for stem in (name, name.partition(".")[0]):
        path = os.path.join(BENCH_DIR, "metrics", f"{stem}.py")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no reader for the metric {name!r} under {BENCH_DIR}/metrics")


def reader(name: str):
    path = reader_path(name)
    stem = os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(f"gpu_bench_metric_{stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def counter(path: str):
    """A kernel wrapper of the program by dotted path (module.attribute)."""
    module, _, attr = path.rpartition(".")
    return getattr(importlib.import_module(module), attr)


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.partition(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Reading:
    """What a metric's reader reads: the set-up time, the window's length,
    its calls (``records``: start, end, pool index, answered), the work of
    each answered call counted from its audio (``audio_s``, ``frames``,
    ``flops``), and, in a traced run, the trace and the kernel groups."""

    def __init__(self, config: dict, records: list, audio_s: list, frames: list, flops: list,
                 setup_s: float, window_s: float, trace: Trace | None = None,
                 groups: dict | None = None):
        self.config, self.records = config, records
        self.audio_s, self.frames, self.flops = audio_s, frames, flops
        self.setup_s, self.window_s = setup_s, window_s
        self.trace, self.groups = trace, groups

    def latencies_ms(self) -> list:
        return [(e - s) * 1e3 for s, e, _, ok in self.records if ok]

    def call_p50_ms(self) -> float:
        return statistics.median(self.latencies_ms())

    def group_s(self, group: str) -> float:
        return self.trace.group_s(self.groups[group])

    def ms_per_audio_s(self, group: str):
        device_s = self.group_s(group)
        return device_s * 1e3 / sum(self.audio_s) if device_s > 0 else None

    def roofline_pct(self, group: str):
        """The group's bound over its device time, in %: None where the
        group has no device time or serves none of this model's layers."""
        g = self.groups[group]
        serves = {"bidirectional": True, "unidirectional": False}.get(g.get("layers"))
        device_s = self.group_s(group)
        if device_s == 0 or (serves is not None and serves != self.config["bidirectional"]):
            return None
        bound = sum(work.bound_s(*work.group_work(g["work"], self.config, f), self.config)
                    for f in self.frames)
        return 100.0 * bound / device_s

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def mfu_pct(self) -> float:
        return 100.0 * sum(self.flops) / (self.trace.window_s * work.peak_flops(self.config))


def run_cell(name: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
             t_start: float | None = None, bench: dict | None = None,
             config: dict | None = None, mix: dict | None = None) -> dict:
    """One run; returns the result line as a dict. ``config`` and ``mix``
    replace the cell's own (the tests' small sizes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = benchmark() if bench is None else bench
    _, cell_config, cell_mix = cell_parts(bench, name)
    config, mix = config or cell_config, mix or cell_mix
    cuda = torch.device(device).type == "cuda"

    d = driver.load(mix["driver"])(config, mix, seed, device)
    d.warm()
    if cuda:
        torch.cuda.synchronize()
    gc.collect()
    setup_s = time.perf_counter() - t_start - d.reference_s
    log(f"set-up {setup_s:.3f} s ({d.reference_s:.3f} s in the reference left out)")

    groups = kernel_groups()
    checks = [c for g in groups.values() for c in g["launch_check"]]
    trace = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        before = [counter(c["counter"]).design_counts[c["design"]] for c in checks]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            window_s, records, outputs = d.drive(seconds, record_function)
            if cuda:
                torch.cuda.synchronize()
        t_read = time.perf_counter()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            trace = Trace.from_file(path)
        finally:
            os.remove(path)
        log(f"trace read in {time.perf_counter() - t_read:.3f} s: "
            f"{len(trace.device)} device operations")
        for c, b in zip(checks, before):
            launched = counter(c["counter"]).design_counts[c["design"]] - b
            seen = trace.count(c["kernel"])
            if seen != launched:
                raise RuntimeError(f"the trace lost launches: {seen} events of {c['kernel']} "
                                   f"against {launched} {c['design']} calls of {c['counter']}")
        if not trace.device:
            raise RuntimeError("the trace holds no device operation")
    else:
        window_s, records, outputs = d.drive(seconds, lambda _: contextlib.nullcontext())

    answered = [d.pool[c] for _, _, c, ok in records if ok]
    failed = sum(d.rows(d.pool[c]) for _, _, c, ok in records if not ok)
    reading = Reading(config, records, [d.audio_s(e) for e in answered],
                      [d.frames(e) for e in answered], [d.flops(e) for e in answered],
                      setup_s, window_s, trace, groups)
    metrics = {}
    for m in metrics_of(bench, "per_layer" if traced else "end_to_end", name):
        value = reader(m["name"])(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_line = {"platform": "gpu" if cuda else device, "count": 1,
                   "kind": torch.cuda.get_device_name(device) if cuda else device,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if cuda else 0}
    if traced:
        device_line["busy_s"] = trace.busy_s
        device_line["window_s"] = trace.window_s

    # the comparison, once the program is freed: the reference's peak is not
    # the program's
    d.release()
    t_ref = time.perf_counter()
    compared = {**d.compare(records, outputs), "failed_requests": {"value": failed, "limit": 0}}
    log(f"window {window_s:.3f} s, {len(records)} calls; compared in "
        f"{time.perf_counter() - t_ref:.3f} s")
    result = {
        "correct": all(v["value"] <= v["limit"] for v in compared.values()),
        "attempted": sum(d.rows(d.pool[c]) for _, _, c, _ in records), "failed": failed,
        "metrics": metrics, "device": device_line,
    }
    if traced:
        result["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
    result["compared"] = compared
    return result
