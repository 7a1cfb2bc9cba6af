"""Median ms a call the host spends issuing device work, from the program's
spans: the uploads, the forward pass's enqueue and the device-to-host
copies (``engine.upload``, ``engine.forward``, ``engine.d2h``)."""

import statistics

import spans

ENQUEUE = ("engine.upload", "engine.forward", "engine.d2h")


def read(reading):
    per_call = spans.call_ms(reading.trace, ENQUEUE)
    return statistics.median(per_call) if per_call else None
