"""Process start to the window: imports, the weights made on the device and
loaded through the program's package path, the pool, every shape warmed
once (and the nvcc build in a fresh checkout); the benchmark's own
reference is left out."""


def read(reading):
    return reading.setup_s
