"""B5's share of its roofline: the least time the LSTM walks' work takes on
the card (counted from the audio, four gates: ``lstm_work.py``) over the
device time of the B5 kernel group; None where the group has no device time
or the model is no LSTM."""

import lstm_work


def read(reading):
    device_s = reading.group_s("b5")
    if device_s == 0 or reading.config.get("rnn_type") != "lstm":
        return None
    bound = sum(lstm_work.recurrence_bound_s(reading.config, f) for f in reading.frames)
    return 100.0 * bound / device_s
