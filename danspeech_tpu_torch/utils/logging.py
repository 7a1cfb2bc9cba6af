"""Structured logging (the logger of ``danspeech_tpu/utils/logging.py``).

Every subsystem logs through a stdlib logger under the
``danspeech_tpu_torch`` name with a single-line structured format, so a
deployment can route and filter it.
"""

from __future__ import annotations

import logging
import sys

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

