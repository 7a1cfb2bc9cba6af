"""B1's share of its roofline: the least time its work takes on the card
(counted from the audio) over its device time."""


def read(reading):
    return reading.roofline_pct("b1")
