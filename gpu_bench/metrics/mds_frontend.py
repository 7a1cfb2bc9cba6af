"""Median ms a call the host spends in Mozilla DeepSpeech's front end, from
the program's spans: the summed ``model.features`` (the MFCC: power
spectrogram, mel filterbank, log, DCT) and ``model.context`` (the context
windows) of each call. None where the window holds no ``model.context``
span (a model without context windows, or a program without the span)."""

import statistics

import spans

FRONT = ("model.features", "model.context")


def read(reading):
    if not any(name == "model.context" for _, _, name in reading.trace.host):
        return None
    per_call = spans.call_ms(reading.trace, FRONT)
    return statistics.median(per_call) if per_call else None
