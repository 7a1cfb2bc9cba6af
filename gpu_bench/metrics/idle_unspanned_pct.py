"""Share of the window's device idle time with no ``engine.`` or ``model.``
span open: the idle time the program's spans cannot name."""

import spans


def read(reading):
    return spans.idle_unspanned_pct(reading.trace)
