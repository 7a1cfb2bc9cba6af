"""Median ms a call the host spends in the LSTM layers' input projections,
from the program's spans: the summed ``model.rnn.project`` of each call
(both directions' products, the bias add and the cast). None where the
window holds no such span."""

import statistics

import spans

PROJECT = "model.rnn.project"


def read(reading):
    if not any(name == PROJECT for _, _, name in reading.trace.host):
        return None
    per_call = spans.call_ms(reading.trace, [PROJECT])
    return statistics.median(per_call) if per_call else None
