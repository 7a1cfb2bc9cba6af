"""Audio seconds of every call answered in the window over the window's wall
time, which ends when the last call returns."""


def read(reading):
    return sum(reading.audio_s) / reading.window_s
