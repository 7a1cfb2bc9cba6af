"""The model's useful operations over the calls answered in the traced
window (counted from the audio), over the window's length at the card's
peak rate."""


def read(reading):
    return reading.mfu_pct()
