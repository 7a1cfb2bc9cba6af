"""The 95th percentile of the wall time of every call answered in the
window."""

import numpy as np


def read(reading):
    return float(np.percentile(reading.latencies_ms(), 95))
