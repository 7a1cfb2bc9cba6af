"""Shared by the kernel wrappers (``gru_cuda``, ``lstm_cuda``,
``rnn_tanh_cuda``): what a wrapper verifies before it launches, and the step
order of a walk."""

from __future__ import annotations

import torch

# the y limit of the grid of the tiled GEMM in csrc/gru_proj.cuh (128 rows
# per block)
_MAX_PROJ_ROWS = 65535 * 128


def check_tensors(anchor: str, expect: dict) -> None:
    """``expect`` maps a name to (tensor, shape, dtype): every tensor must be
    contiguous, of that shape and dtype, on the device of ``expect[anchor]``."""
    dev = expect[anchor][0].device
    for name, (t, shape, dtype) in expect.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, {anchor} on {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype:
            raise TypeError(
                f"{name} is {t.dtype}, the kernel takes {dtype} (the recurrent "
                "kernels take bf16 sequences and weights only, ROADMAP A6b)"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_stream_shape(name: str, t: torch.Tensor, gates: int, hidden: int) -> None:
    """``t`` must be a non-empty (T, B, gates * hidden) sequence."""
    if t.dim() != 3 or t.shape[2] != gates * hidden:
        raise ValueError(
            f"{name} must be (T, B, {gates}H) with H = {hidden}, got shape "
            f"{tuple(t.shape)}"
        )
    if t.shape[0] == 0 or t.shape[1] == 0:
        raise ValueError(f"empty input: {name} shape {tuple(t.shape)}")


def check_proj_rows(t_max: int, batch: int) -> None:
    """T * B rows must fit the grid of the tiled GEMM."""
    if t_max * batch > _MAX_PROJ_ROWS:
        raise ValueError(f"T*B = {t_max * batch} rows exceed the projection grid")


def time_order(t_max: int, reverse: bool) -> range:
    """The walk's step order: T-1 .. 0 when ``reverse``, else 0 .. T-1."""
    return range(t_max - 1, -1, -1) if reverse else range(t_max)
