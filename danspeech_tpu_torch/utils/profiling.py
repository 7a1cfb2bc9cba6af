"""Profiling helpers: the port of ``danspeech_tpu/utils/profiling.py`` on
``torch.profiler``.

:func:`device_trace` captures a trace of the host and, on CUDA, the device
around any pipeline call and writes it under ``log_dir`` (Chrome trace
JSON, readable in Perfetto and TensorBoard's profiler); :func:`annotate`
names a range inside it. The engine and the model's forward pass mark
their steps with :func:`annotate` (``engine.*`` and ``model.*``,
``docs/torch_architecture.md``); a span exists only while a profiler
records, so with none it costs one check.
"""

from __future__ import annotations

import contextlib
import os

import torch

_OFF = contextlib.nullcontext()


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
    """A named range that shows up inside traces: ``record_function`` while
    a profiler records, else one shared no-op context (``record_function``
    alone costs some 10 µs a span even with no profiler, the check under
    1 µs)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
