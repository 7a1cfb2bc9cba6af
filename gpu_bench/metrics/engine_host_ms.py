"""Median ms a call of the engine's host-only work, from the program's
spans: planning, staging, the greedy collapse and a beam decoder's decode
(``engine.plan``, ``engine.stage``, ``engine.collapse``, ``engine.decode``)."""

import statistics

import spans

HOST = ("engine.plan", "engine.stage", "engine.collapse", "engine.decode")


def read(reading):
    per_call = spans.call_ms(reading.trace, HOST)
    return statistics.median(per_call) if per_call else None
