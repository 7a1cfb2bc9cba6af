"""The work a model does, counted from the audio: operations and bytes a
layer needs for the valid frames of each utterance, at the configuration's
widths. Never from the program's dispatch groups or its padding.

The arithmetic is that of ``chip_smoke.py`` (``gru_bound``, ``scan_bound``):
a multiply-add is two operations; a kernel's bytes count each input byte
read once and each output byte written once. Weights are inputs of each
API call, read once a call.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense rates (data sheet): bf16 tensor cores, float32
# outside the tensor cores, HBM3
PEAK_FLOPS = {2: 989e12, 4: 67e12}
PEAK_BYTES_PER_S = 3.35e12
F32 = 4

# (kernel, stride, padding) along (freq, time) and channels of the conv layers
CONV_SPECS = (
    ((41, 11), (2, 2), (20, 5), 1, 32),
    ((21, 11), (2, 1), (10, 5), 32, 32),
    ((21, 11), (2, 1), (10, 5), 32, 96),
)


def operand_bytes(config: dict) -> int:
    """Bytes of a product's operand: bf16 unless the configuration serves
    in float32."""
    return F32 if config.get("compute_dtype") == "float32" else 2


def peak_flops(config: dict) -> float:
    return PEAK_FLOPS[operand_bytes(config)]


def n_freq(config: dict) -> int:
    audio = config["audio_conf"]
    return int(audio["sampling_rate"] * audio["window_size"]) // 2 + 1


def hop(config: dict) -> int:
    audio = config["audio_conf"]
    return int(audio["sampling_rate"] * audio["window_stride"])


def utterance_frames(n_samples: int, config: dict) -> int:
    """Frames after the conv stack: 1 + n // hop spectrogram frames, then
    each conv's time stride."""
    frames = 1 + n_samples // hop(config)
    for (_, kt), (_, st), (_, pt), _, _ in CONV_SPECS[: config["conv_layers"]]:
        frames = (frames + 2 * pt - kt) // st + 1
    return frames


def conv_ops(config: dict) -> list:
    """Operations a frame (frames counted after the conv stack) of each
    conv layer."""
    out, f_in = [], n_freq(config)
    for (kf, kt), (sf, _), (pf, _), c_in, c_out in CONV_SPECS[: config["conv_layers"]]:
        f_out = (f_in + 2 * pf - kf) // sf + 1
        out.append(2 * kf * kt * c_in * c_out * f_out)
        f_in = f_out
    return out


def rnn_layers(config: dict) -> list:
    """Per recurrent layer: (input width D, hidden H, directions)."""
    dirs = 2 if config["bidirectional"] else 1
    hidden = config["rnn_hidden_size"]
    f_last, c_last = n_freq(config), 1
    for (kf, _), (sf, _), (pf, _), _, c_out in CONV_SPECS[: config["conv_layers"]]:
        f_last, c_last = (f_last + 2 * pf - kf) // sf + 1, c_out
    widths = [f_last * c_last] + [hidden] * (config["rnn_layers"] - 1)
    return [(d, hidden, dirs) for d in widths]


def model_flops_per_frame(config: dict) -> float:
    """Operations of the model a frame: the convolutions, every GRU layer's
    input and recurrent products, the lookahead, the head."""
    total = sum(conv_ops(config))
    for d, h, dirs in rnn_layers(config):
        total += dirs * 2 * (d + h) * 3 * h
    hidden = config["rnn_hidden_size"]
    if not config["bidirectional"]:
        total += 2 * hidden * config["context"]
    return total + 2 * hidden * len(config["labels"])


def group_work(terms: list, config: dict, frames: int) -> tuple:
    """(operations, bytes) of one API call over ``frames`` valid frames, for
    a kernel group that does ``terms`` of every GRU layer, both directions
    where there are two: ``"rnn_projection"`` and ``"rnn_recurrence"``
    together read the input x and both weights and write the outputs;
    ``"rnn_recurrence"`` alone reads the projected gx and w_hh."""
    ob = operand_bytes(config)
    both = "rnn_projection" in terms
    flops = nbytes = 0
    for d, h, dirs in rnn_layers(config):
        width = (d + h) if both else h
        flops += dirs * 2 * width * 3 * h * frames
        per_frame = d * ob if both else dirs * 3 * h * ob
        per_call = dirs * (width * 3 * h * ob + 2 * 3 * h * F32)
        nbytes += frames * (per_frame + dirs * h * ob) + per_call
    return flops, nbytes


def bound_s(flops: float, nbytes: float, config: dict) -> float:
    """The least time the card could take: the larger of the operations over
    the peak rate and the bytes over the memory rate."""
    return max(flops / peak_flops(config), nbytes / PEAK_BYTES_PER_S)
