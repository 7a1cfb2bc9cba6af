"""Share of the traced window with no operation on the device."""


def read(reading):
    return reading.idle_pct()
