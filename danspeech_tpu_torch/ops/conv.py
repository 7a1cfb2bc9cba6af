"""Conv stack ops: masked 2D convs, eval-mode batchnorm, hardtanh, lookahead.

The port of ``danspeech_tpu/ops/conv.py``. The convolutions are
``torch.nn.functional.conv2d`` (the JAX package leaves them to XLA).
The JAX package's TPU layouts of the same convolutions are here too
(``conv2d_banded_cin1``, ``conv2d_s2d_cin1``, ``conv2d_s2d_freq``): the
same phase split or band, then one ``F.conv2d`` or matmul. ``conv_block``
keeps ``conv2d`` for every layer (the JAX one takes ``conv2d_s2d_cin1`` for
the C_in=1 stride-(2,2) first conv); ``chip_smoke.py`` phase 11a times
each layout against cuDNN. As in ``conv2d``, a bf16 product rounds its
output to bf16 before the float32 bias add (ROADMAP C5). Layouts are the
JAX package's: NCHW activations, (O, I, Kf, Kt) kernels, (T, B, H)
sequences. The lookahead is :mod:`.lookahead_cuda`'s stencil, a kernel of
its own on CUDA (``csrc/lookahead.cu``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import lookahead_cuda


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


def _out_size(n: int, kernel: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - kernel) // stride + 1


def _add_bias(out: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    out = out.float()
    if bias is not None:
        out = out + bias.float()[None, :, None, None]
    return out


def conv2d_banded_cin1(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None,
    stride: tuple[int, int],
    padding: tuple[int, int],
) -> torch.Tensor:
    """The C_in=1 Conv2d as one dense banded matmul: the time taps become
    KT strided views of the input, the frequency kernel a banded
    (KT*F_pad, F_out*O) matrix, and the layer one (B*T_out, KT*F_pad) x
    (KT*F_pad, F_out*O) product (about 5x the operations of the direct
    convolution, the band's zeros, but dense)."""
    b, cin, f, t = x.shape
    if cin != 1:
        raise ValueError("the banded form applies to the C_in=1 first conv only")
    o, _, kf, kt = weight.shape
    sf, st = stride
    pf, pt = padding
    f_out, t_out = _out_size(f, kf, sf, pf), _out_size(t, kt, st, pt)
    fp = f + 2 * pf
    dev = x.device

    xpad = F.pad(x[:, 0], (pt, pt, pf, pf))  # (B, Fp, Tp)
    # the band: m[ktap, fi, f', oc] = w[oc, 0, fi - sf*f', ktap]
    kf_idx = (torch.arange(fp, device=dev)[:, None]
              - sf * torch.arange(f_out, device=dev)[None, :])  # (Fp, F_out)
    valid = (kf_idx >= 0) & (kf_idx < kf)
    w_g = weight[:, 0][:, kf_idx.clamp(0, kf - 1), :]  # (O, Fp, F_out, KT)
    m = torch.where(valid[None, :, :, None], w_g, torch.zeros((), dtype=w_g.dtype,
                                                              device=dev))
    m = m.permute(3, 1, 2, 0).reshape(kt * fp, f_out * o)
    # z[b, t', k, fi] = xpad[b, fi, st*t' + k]
    z = torch.stack([xpad[:, :, k : k + st * (t_out - 1) + 1 : st] for k in range(kt)],
                    dim=1)  # (B, KT, Fp, T_out)
    z = z.permute(0, 3, 1, 2).reshape(b * t_out, kt * fp)
    out = torch.matmul(z.to(weight.dtype), m)  # (B*T_out, F_out*O)
    out = out.reshape(b, t_out, f_out, o).permute(0, 3, 2, 1)  # NCHW
    return _add_bias(out, bias)


def conv2d_s2d_cin1(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None,
    stride: tuple[int, int],
    padding: tuple[int, int],
) -> torch.Tensor:
    """The C_in=1 stride-(2,2) Conv2d by space-to-depth: the four 2x2 input
    phases become four channels and the convolution runs at stride 1 on
    the half-resolution grid with each phase's kernel taps."""
    b, cin, f, t = x.shape
    if cin != 1 or tuple(stride) != (2, 2):
        raise ValueError("space-to-depth here needs C_in=1 and stride (2, 2)")
    o, _, kf, kt = weight.shape
    pf, pt = padding
    dev = x.device
    # one more on the high sides so that every phase slice has equal length
    xp = F.pad(x, (pt, pt + 1, pf, pf + 1))
    phases = [xp[:, :, i::2, j::2] for i in range(2) for j in range(2)]
    fmin = min(p.shape[2] for p in phases)
    tmin = min(p.shape[3] for p in phases)
    xs = torch.cat([p[:, :, :fmin, :tmin] for p in phases], dim=1)
    # tap (i, j) lands in channel 2*(i%2) + j%2 at (i//2, j//2)
    wp = torch.zeros((o, 4, (kf + 1) // 2, (kt + 1) // 2), dtype=weight.dtype, device=dev)
    ii, jj = torch.meshgrid(torch.arange(kf, device=dev), torch.arange(kt, device=dev),
                            indexing="ij")
    wp[:, (ii % 2) * 2 + jj % 2, ii // 2, jj // 2] = weight[:, 0]
    out = F.conv2d(xs.to(weight.dtype), wp)
    f_out, t_out = _out_size(f, kf, 2, pf), _out_size(t, kt, 2, pt)
    return _add_bias(out[:, :, :f_out, :t_out], bias)


def conv2d_s2d_freq(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None,
    stride: tuple[int, int],
    padding: tuple[int, int],
) -> torch.Tensor:
    """The stride-(2,1) Conv2d by space-to-depth on the frequency axis only:
    the two frequency phases become channel blocks (C_in doubles) and the
    convolution runs at stride 1 on the half-resolution frequency grid; the
    counterpart of :func:`conv2d_s2d_cin1` for the second and third convs."""
    b, cin, f, t = x.shape
    if tuple(stride) != (2, 1):
        raise ValueError("frequency space-to-depth needs stride (2, 1)")
    o, _, kf, kt = weight.shape
    pf, pt = padding
    dev = x.device
    # one more on the high frequency side so both phase slices have equal length
    xp = F.pad(x, (pt, pt, pf, pf + 1))
    ph0, ph1 = xp[:, :, 0::2], xp[:, :, 1::2]
    fmin = min(ph0.shape[2], ph1.shape[2])
    xs = torch.cat([ph0[:, :, :fmin], ph1[:, :, :fmin]], dim=1)
    # tap fi of input channel c lands in channel (fi%2)*C + c at tap fi//2
    wp = torch.zeros((o, 2 * cin, (kf + 1) // 2, kt), dtype=weight.dtype, device=dev)
    ii = torch.arange(kf, device=dev)
    wp[:, (ii % 2)[:, None] * cin + torch.arange(cin, device=dev)[None, :],
       (ii // 2)[:, None], :] = weight.permute(0, 2, 1, 3)
    out = F.conv2d(xs.to(weight.dtype), wp)
    f_out, t_out = _out_size(f, kf, 2, pf), _out_size(t, kt, 1, pt)
    return _add_bias(out[:, :, :f_out, :t_out], bias)


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
    """Lookahead convolution over future context on (T, B, H), in float32:
    out[t] = sum_k w[:, k] * x[t + k], right-padded with context-1 zeros.
    The stencil kernel on CUDA, the stacked plain version on the CPU
    (:mod:`.lookahead_cuda`)."""
    return lookahead_cuda.lookahead(x.float(), p.weight.float())
