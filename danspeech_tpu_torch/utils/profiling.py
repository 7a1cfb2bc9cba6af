"""Profiling helpers: the port of ``danspeech_tpu/utils/profiling.py`` on
``torch.profiler``.

:func:`device_trace` captures a trace of the host and, on CUDA, the device
around any pipeline call and writes it under ``log_dir`` (Chrome trace
JSON, readable in Perfetto and TensorBoard's profiler); :func:`annotate`
names a range inside it; :func:`amortized_seconds` gives the steady-state
time of one call, synchronising the card once after many calls rather than
after each.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block under ``log_dir``
    (``trace_<pid>_<n>.json``); the device's activity is included when CUDA
    is available."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


def annotate(name: str):
    """A named range that shows up inside traces."""
    return torch.profiler.record_function(name)


def amortized_seconds(fn, *args, iters: int = 10, warmup: int = 1) -> float:
    """Steady-state seconds per call of ``fn``: ``iters`` calls enqueued
    back to back and one synchronisation at the end (``torch.cuda.synchronize``
    when the output holds a CUDA tensor), so no per-call round trip is
    counted."""
    out = None
    for _ in range(max(1, warmup)):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for v in out:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def _sync(out):
    t = _first_tensor(out)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
