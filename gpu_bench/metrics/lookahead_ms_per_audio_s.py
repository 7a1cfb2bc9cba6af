"""Device ms of the lookahead kernel group per audio second served."""


def read(reading):
    return reading.ms_per_audio_s("lookahead")
