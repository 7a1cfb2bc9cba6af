"""Median wall time of a call in the traced window, from the benchmark's
spans around each call (the API and the scheduler)."""


def read(reading):
    return reading.call_p50_ms()
