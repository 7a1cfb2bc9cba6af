"""Shared by the kernel wrappers (``gru_cuda``, ``lstm_cuda``,
``rnn_tanh_cuda``): what a wrapper verifies before it launches, and the step
order of a walk."""

from __future__ import annotations

import torch

# the y limit of the grid of the tiled GEMM in csrc/gru_proj.cuh (128 rows
# per block)
_MAX_PROJ_ROWS = 65535 * 128


def check_tensors(anchor: str, expect: dict) -> torch.dtype:
    """``expect`` maps a name to (tensor, shape, dtype): every tensor must be
    contiguous, of that shape and dtype, on the device of ``expect[anchor]``.
    The dtypes given are the bf16 set's: bf16 sequences and weights, f32
    biases and states, int32 lengths. The all-float32 set, which the float32
    variants of every kernel take, is taken too, chosen by the anchor's
    dtype: every floating tensor f32. A mixed set raises TypeError. Returns
    the set's dtype, torch.bfloat16 or torch.float32."""
    family = torch.bfloat16
    if expect[anchor][0].dtype == torch.float32:
        family = torch.float32
    dev = expect[anchor][0].device
    for name, (t, shape, dtype) in expect.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, {anchor} on {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if dtype.is_floating_point and family == torch.float32:
            dtype = torch.float32
        if t.dtype != dtype:
            if family == torch.float32:
                rule = (f"{anchor} is float32, so the kernel takes the all-float32 set: "
                        "every sequence, weight, bias and state float32")
            else:
                rule = ("the kernels take bf16 sequences and weights with f32 biases "
                        "and states, or everything in float32")
            raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype} ({rule})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return family


def count(wrapper, design: str, dtype: torch.dtype, n: int = 1) -> None:
    """``n`` more launches of ``wrapper``: ``launches``, and ``design_counts``
    and ``dtype_counts`` by the design and the operand set taken."""
    wrapper.launches += n
    wrapper.design_counts[design] += n
    wrapper.dtype_counts[str(dtype).rpartition(".")[2]] += n


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
