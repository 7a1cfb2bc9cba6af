"""The lookahead stencil (``csrc/lookahead.cu``) and its plain PyTorch version.

The lookahead of unidirectional models is a depthwise convolution over
future frames: ``out[t, b, h] = sum_k w[h, k] * x[t + k, b, h]`` over
(T, B, H), x zero from ``t + k >= T`` on. The JAX package writes it as C
shifted copies stacked and one einsum (``danspeech_tpu/ops/conv.py``
``lookahead``), which XLA fuses; it has no Pallas kernel. That formulation
is kept here as the plain version, :func:`lookahead_plain`. On a CUDA tensor
:func:`lookahead` launches ``lookahead_stencil_kernel``, which reads x once
and writes the output once (the source's note says how), and raises on
anything the kernel does not take; on a CPU tensor, and only there, it runs
the plain version. There is no fallback from a failed build or launch.

:func:`lookahead` is differentiable (unidirectional models train through
``forward``): dx is the same kernel walking past taps,
``dx[s] = sum_k w[:, k] * dout[s - k]`` (:func:`lookahead_past_plain` on the
CPU), and dw a loop of C shifted multiply-reduce passes in PyTorch, one per
tap; neither builds the stack of C copies.

``lookahead.launches``, ``lookahead.design_counts["stencil"]`` and
``lookahead.dtype_counts["float32"]`` count the kernel's launches, the
gradient's past-tap walks among them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_build
from .cuda_checks import check_tensors, count

# the contexts the kernel is built for (csrc/lookahead.cu, LA_MAX_C)
MAX_CONTEXT = 32


def lookahead_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The stencil as C shifted copies stacked and one einsum, on any device:
    x (T, B, H) and w (H, C) float32, right-padded with C - 1 zero rows."""
    t = x.shape[0]
    context = w.shape[1]
    x_pad = F.pad(x, (0, 0, 0, 0, 0, context - 1))
    stacked = torch.stack([x_pad[k : k + t] for k in range(context)])
    return torch.einsum("ctbh,hc->tbh", stacked, w)


def lookahead_past_plain(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The past-tap walk, ``out[s] = sum_k w[:, k] * g[s - k]`` with g zero
    below s = 0: the transpose of :func:`lookahead_plain`, so the gradient of
    its x. The stacked formulation left-padded."""
    t = g.shape[0]
    context = w.shape[1]
    g_pad = F.pad(g, (0, 0, 0, 0, context - 1, 0))
    stacked = torch.stack([g_pad[context - 1 - k : context - 1 - k + t]
                           for k in range(context)])
    return torch.einsum("ctbh,hc->tbh", stacked, w)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    """x (T, B, H) and w (H, C) non-empty float32 on one device; on CUDA,
    C at most MAX_CONTEXT."""
    if x.dim() != 3 or w.dim() != 2 or w.shape[0] != x.shape[2]:
        raise ValueError(f"x must be (T, B, H) and w (H, C), got shapes "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if min(x.shape) == 0 or w.shape[1] == 0:
        raise ValueError(f"empty input: x {tuple(x.shape)}, w {tuple(w.shape)}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}, the lookahead takes float32 x and w")
    if x.device != w.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.device.type == "cuda" and w.shape[1] > MAX_CONTEXT:
        raise ValueError(f"context {w.shape[1]}: the kernel takes 1 to {MAX_CONTEXT} taps")


def _launch(x: torch.Tensor, w: torch.Tensor, reverse: bool) -> torch.Tensor:
    """One launch of ``lookahead_stencil_launch`` on contiguous x and w."""
    t_max, batch, hidden = x.shape
    check_tensors("x", {"x": (x, (t_max, batch, hidden), torch.float32),
                        "w": (w, (hidden, w.shape[1]), torch.float32)})
    launch = cuda_build.bind("lookahead", "lookahead_stencil_launch", 3, 5)
    out = torch.empty_like(x)
    cuda_build.call(launch, "lookahead_stencil", x.device,
                    x.data_ptr(), w.data_ptr(), out.data_ptr(),
                    t_max, batch, hidden, w.shape[1], int(bool(reverse)))
    return out


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version); any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cuda"


def stencil(x: torch.Tensor, w: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """The future-tap stencil of x (or, ``reverse``, the past-tap walk),
    no gradient: the kernel for CUDA tensors (x made contiguous first), the
    plain version for CPU ones."""
    _check(x, w)
    if not _on_card(x):
        return lookahead_past_plain(x, w) if reverse else lookahead_plain(x, w)
    out = _launch(x.contiguous(), w, reverse)
    count(lookahead, "stencil", torch.float32)
    return out


def tap_grads(x: torch.Tensor, g: torch.Tensor, context: int) -> torch.Tensor:
    """dw (H, C) of the stencil: ``dw[h, k] = sum_{t, b} g[t, b, h] *
    x[t + k, b, h]``, one shifted multiply-reduce pass a tap."""
    t = x.shape[0]
    dw = x.new_zeros((x.shape[2], context))
    for k in range(min(context, t)):
        dw[:, k] = (g[: t - k] * x[k:]).sum(dim=(0, 1))
    return dw


class _Lookahead(torch.autograd.Function):
    """The stencil with its gradient: dx the past-tap walk of dout, dw
    :func:`tap_grads`."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return stencil(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = stencil(g, w, reverse=True) if ctx.needs_input_grad[0] else None
        dw = tap_grads(x, g, w.shape[1]) if ctx.needs_input_grad[1] else None
        return dx, dw


def lookahead(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The lookahead over (T, B, H): ``out[t] = sum_k w[:, k] * x[t + k]``,
    x and w (H, C) float32, differentiable in both. A CUDA x launches the
    kernel or raises; a CPU x runs the plain version."""
    return _Lookahead.apply(x, w)


lookahead.launches = 0
lookahead.design_counts = {"stencil": 0}
lookahead.dtype_counts = {"float32": 0}
