"""Share of the engine's time that the host waits on the device: the summed
``engine.wait`` spans over the summed ``engine.call`` spans of the window."""

import spans


def read(reading):
    calls = spans.total_ms(reading.trace, "engine.call")
    return 100.0 * spans.total_ms(reading.trace, "engine.wait") / calls if calls else None
