"""Conv stack ops: masked 2D convs, eval-mode batchnorm, hardtanh, lookahead.

The port of ``danspeech_tpu/ops/conv.py``. The convolutions are
``torch.nn.functional.conv2d`` (the JAX package leaves them to XLA); the
TPU layout variants of the reference (banded and space-to-depth convs) have
no counterpart here. Layouts are the JAX package's: NCHW activations,
(O, I, Kf, Kt) kernels, (T, B, H) sequences.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class ConvParams(NamedTuple):
    """One conv block: Conv2d + BatchNorm2d (eval stats)."""

    weight: torch.Tensor  # (O, I, Kf, Kt)
    bias: torch.Tensor  # (O,)
    bn_gamma: torch.Tensor  # (O,)
    bn_beta: torch.Tensor  # (O,)
    bn_mean: torch.Tensor  # (O,)
    bn_var: torch.Tensor  # (O,)


class BatchNormParams(NamedTuple):
    gamma: torch.Tensor
    beta: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor

    def scale_shift(self, eps: float = 1e-5):
        scale = self.gamma / torch.sqrt(self.var + eps)
        return scale, self.beta - self.mean * scale


class LinearParams(NamedTuple):
    weight: torch.Tensor  # (out, in)
    bias: torch.Tensor | None


class LookaheadParams(NamedTuple):
    weight: torch.Tensor  # (H, context): depthwise taps over future frames


def hardtanh(x: torch.Tensor, lo: float = 0.0, hi: float = 20.0) -> torch.Tensor:
    """Hardtanh(0, 20), the conv and lookahead activation."""
    return x.clamp(lo, hi)


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None,
    stride: tuple[int, int],
    padding: tuple[int, int],
) -> torch.Tensor:
    """torch.nn.Conv2d on NCHW input. The input is cast to the kernel's
    dtype (bf16 kernels give a bf16 convolution); the output and the bias
    add are float32."""
    out = F.conv2d(x.to(weight.dtype), weight, None, stride, padding).float()
    if bias is not None:
        out = out + bias.float()[None, :, None, None]
    return out


def batchnorm_eval(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    eps: float = 1e-5,
    channel_axis: int = 1,
) -> torch.Tensor:
    """BatchNorm in eval mode: a per-channel affine with running stats."""
    shape = [1] * x.dim()
    shape[channel_axis] = -1
    scale = gamma / torch.sqrt(var + eps)
    shift = beta - mean * scale
    return x * scale.reshape(shape) + shift.reshape(shape)


def fold_bn_into_conv(p: ConvParams, eps: float = 1e-5):
    """Eval-mode BN folded into the conv weight and bias (exact for
    inference): w' = w * gamma/sqrt(var+eps) per output channel."""
    scale = p.bn_gamma / torch.sqrt(p.bn_var + eps)
    w = p.weight * scale.to(p.weight.dtype)[:, None, None, None]
    b = (p.bias - p.bn_mean) * scale + p.bn_beta
    return w, b


def time_mask(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Zero (N, C, F, T) activations past each row's sequence length."""
    t = x.shape[-1]
    mask = torch.arange(t, device=x.device)[None, :] < lengths.to(x.device)[:, None]
    return x * mask.to(x.dtype)[:, None, None, :]


def conv_block(
    x: torch.Tensor,
    p: ConvParams,
    lengths: torch.Tensor,
    stride: tuple[int, int],
    padding: tuple[int, int],
    folded: bool = True,
) -> torch.Tensor:
    """conv -> BN(eval) -> hardtanh -> length mask, optionally BN folded."""
    if folded:
        w, b = fold_bn_into_conv(p)
        out = conv2d(x, w, b, stride, padding)
    else:
        out = conv2d(x, p.weight, p.bias, stride, padding)
        out = batchnorm_eval(out, p.bn_gamma, p.bn_beta, p.bn_mean, p.bn_var)
    return time_mask(hardtanh(out), lengths)


def conv_out_length(length, kernel: int, stride: int, padding: int, dilation: int = 1):
    """Conv output length along one axis (ints or integer tensors)."""
    return (length + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1


def lookahead(x: torch.Tensor, p: LookaheadParams) -> torch.Tensor:
    """Lookahead convolution over future context on (T, B, H):
    out[t] = sum_k w[:, k] * x[t + k], right-padded with context-1 zeros."""
    t = x.shape[0]
    context = p.weight.shape[1]
    x_pad = F.pad(x.float(), (0, 0, 0, 0, 0, context - 1))
    stacked = torch.stack([x_pad[k : k + t] for k in range(context)])
    return torch.einsum("ctbh,hc->tbh", stacked, p.weight.float())
