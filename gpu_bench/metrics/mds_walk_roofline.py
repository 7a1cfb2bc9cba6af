"""B5's share of its roofline in Mozilla DeepSpeech: the least time its LSTM
walk's work takes on the card (one chain, four gates, frames counted from
the audio: ``mozilla_work.py``) over the device time of the B5 kernel group;
None where the group has no device time or the model is not Mozilla
DeepSpeech."""

import mozilla_work


def read(reading):
    device_s = reading.group_s("b5")
    if device_s == 0 or reading.config.get("family") != "mozilla":
        return None
    bound = sum(mozilla_work.walk_bound_s(reading.config, f) for f in reading.frames)
    return 100.0 * bound / device_s
