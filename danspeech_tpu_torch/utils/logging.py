"""Structured logging (a copy of ``danspeech_tpu/utils/logging.py``).

Every subsystem logs through a stdlib logger under the
``danspeech_tpu_torch`` name with a single-line structured format, so a
deployment can route and filter it; :func:`metrics` emits key=value pairs
that machines can scrape.
"""

from __future__ import annotations

import logging
import sys
import time

_FORMAT = "%(asctime)s %(levelname).1s %(name)s %(message)s"
_configured = False


def get_logger(name: str = "danspeech_tpu_torch") -> logging.Logger:
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, "%H:%M:%S"))
        root = logging.getLogger("danspeech_tpu_torch")
        if not root.handlers:
            root.addHandler(handler)
        root.setLevel(logging.INFO)
        _configured = True
    return logging.getLogger(name)


def metrics(logger: logging.Logger, event: str, **kv) -> None:
    """One structured metrics line: ``event key=value ...``."""
    parts = [event] + [
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in kv.items()
    ]
    logger.info(" ".join(parts))


class Timed:
    """Context manager logging a stage duration as a metrics line."""

    def __init__(self, logger: logging.Logger, event: str, **kv):
        self.logger = logger
        self.event = event
        self.kv = kv

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        metrics(
            self.logger, self.event,
            seconds=time.perf_counter() - self.t0, **self.kv,
        )
        return False
