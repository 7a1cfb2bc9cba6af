"""What a cell's window drives: one class of its own a traffic mix names.

A traffic mix (``traffic/<name>.json``) names its ``driver``; the harness
loads ``drivers/<driver>.py`` and builds its ``Driver`` class from the
cell's configuration, the mix, the seed and the device. The driver owns
everything that depends on the program's entry point: building the system
under test and the pool of calls from the seed, warming every shape the
window uses, one call, the work each call carries, and the comparison that
decides ``correct``. The harness owns the clock, the window, the trace and
the metrics, and reads them through this interface only. A new entry point
(a train step, a streaming chunk, an open-loop caller) is a new file under
``drivers/``.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import time

import work

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


def load(name: str):
    """The ``Driver`` class of ``drivers/<name>.py``."""
    path = os.path.join(BENCH_DIR, "drivers", f"{name}.py")
    if not os.path.exists(path):
        raise SystemExit(f"no driver {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"gpu_bench_driver_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Driver


class Driver:
    """The default closed loop over ``pool``; a subclass builds the system
    and the pool and gives :meth:`call` and :meth:`compare`.

    ``reference_s`` is the set-up time spent in the benchmark's own
    reference (not the program's); the harness leaves it out of
    ``setup_s``."""

    reference_s = 0.0

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.pool: list = []

    def call(self, entry):
        """One call into the program with a pool entry; returns its output."""
        raise NotImplementedError

    def answered(self, entry, out) -> bool:
        """Whether ``out`` answers every request of ``entry``."""
        return out is not None

    def rows(self, entry) -> int:
        """Requests a call carries (``attempted``, ``failed``)."""
        return len(entry)

    def audio_s(self, entry) -> float:
        """Audio seconds a call carries."""
        return sum(len(w) for w in entry) / self.mix["sample_rate"]

    def frames(self, entry) -> int:
        """Valid frames after the conv stack a call carries."""
        return sum(work.utterance_frames(len(w), self.config) for w in entry)

    def flops(self, entry) -> float:
        """The model's useful operations in a call, counted from the audio."""
        return work.model_flops_per_frame(self.config) * self.frames(entry)

    def warm(self) -> None:
        """Every shape the window uses, built and run once."""
        for entry in self.pool:
            self.call(entry)

    def drive(self, seconds: float, span) -> tuple:
        """Closed loop over the pool, in order, until ``seconds`` have
        passed; the window ends when the last call returns. Returns (window
        seconds, records (start, end, pool index, answered), outputs)."""
        records, outputs = [], []
        with span("bench.window"):
            t0 = time.perf_counter()
            i = 0
            while not records or records[-1][1] - t0 < seconds:
                c = i % len(self.pool)
                s = time.perf_counter()
                try:
                    with span("bench.call"):
                        out = self.call(self.pool[c])
                    ok = self.answered(self.pool[c], out)
                except Exception as exc:  # a call that fails is counted, not fatal
                    print(f"call {i} failed: {exc!r}", file=sys.stderr)
                    out, ok = None, False
                records.append((s, time.perf_counter(), c, ok))
                outputs.append(out)
                i += 1
        return records[-1][1] - t0, records, outputs

    def release(self) -> None:
        """Free the program's state before the reference runs."""

    def compare(self, records: list, outputs: list) -> dict:
        """{name: {"value", "limit"}} of each number compared; the run is
        correct where every value is at most its limit."""
        raise NotImplementedError
