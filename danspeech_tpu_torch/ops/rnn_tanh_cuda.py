"""tanh-RNN kernels and their plain PyTorch versions.

The ports of two kernels of ``danspeech_tpu/ops/pallas_gru.py``:

- :func:`rnn_tanh_scan` (``rnn_tanh_scan``, ``csrc/rnn_tanh_scan.cu``): one
  chain ``h' = tanh(gx + h @ w_hh)`` from h = 0, with a ``reverse`` flag
  (serving and the training forward);
- :func:`rnn_tanh_bwd_scan` (``rnn_tanh_bwd_scan``,
  ``csrc/rnn_tanh_bwd.cu``): the backward walk of one chain, which reads
  tanh' off the stored output stream.

These take a projection ``gx`` that already holds ``b_ih + b_hh`` (added in
f32, then rounded to the stream dtype, as the JAX package's
``_rnn_project``); the kernels have no bias. Each source's header note says
what bounds it on an H100 and what the design does about it. A wrapper
launches its kernel for CUDA tensors and raises on anything the kernel does
not take; for CPU tensors, and only for those, it runs the plain version.
There is no fallback from a failed build or launch to the plain version.
"""

from __future__ import annotations

import torch

from . import cuda_build
from .cuda_checks import check_stream_shape, check_tensors, time_order


def rnn_tanh_scan_plain(gx, lengths, w_hh, reverse: bool = False):
    """The kernel's arithmetic in plain tensor ops, on any device.

    gx (T, B, H) is the projection ``x @ w_ih + b_ih + b_hh`` in the stream
    dtype, w_hh (H, H) in the weights' dtype, lengths (B,). The chain starts
    from h = 0. Returns (out (T, B, H) in gx's dtype with exact zeros where
    t >= length, h_last (B, H) f32). ``reverse`` walks t = T-1 .. 0 and holds
    the state until t < length. The product takes h rounded to w_hh's dtype
    and accumulates in f32 (both operands upcast first).
    """
    t_max, batch, hidden = gx.shape
    dev = gx.device
    mm_dtype = w_hh.dtype
    w = w_hh.float()
    lengths = lengths.to(dev)
    h = torch.zeros((batch, hidden), dtype=torch.float32, device=dev)
    out = torch.empty((t_max, batch, hidden), dtype=gx.dtype, device=dev)
    for t in time_order(t_max, reverse):
        h_new = torch.tanh(gx[t].float() + h.to(mm_dtype).float() @ w)
        valid = (lengths > t)[:, None]
        h = torch.where(valid, h_new, h)
        out[t] = torch.where(valid, h_new, torch.zeros_like(h_new)).to(gx.dtype)
    return out, h


def _check_operands(seq_name, seq, lengths, w_hh):
    if w_hh.dim() != 2 or w_hh.shape[0] != w_hh.shape[1]:
        raise ValueError(f"w_hh must be (H, H), got shape {tuple(w_hh.shape)}")
    hidden = w_hh.shape[0]
    check_stream_shape(seq_name, seq, 1, hidden)
    t_max, batch, _ = seq.shape
    check_tensors(seq_name, {
        seq_name: (seq, (t_max, batch, hidden), torch.bfloat16),
        "lengths": (lengths, (batch,), torch.int32),
        "w_hh": (w_hh, (hidden, hidden), torch.bfloat16),
    })


def rnn_tanh_scan(gx, lengths, w_hh, reverse: bool = False):
    """One tanh-RNN chain over a precomputed projection, from h = 0.

    Same contract and return values as :func:`rnn_tanh_scan_plain`. A CUDA
    ``gx`` launches the kernel (bf16 gx and w_hh, int32 lengths, all
    contiguous on gx's device) or raises; a CPU ``gx`` runs the plain
    version. ``rnn_tanh_scan.launches`` counts kernel launches (one per
    call: the T step kernels of one chain).
    """
    if gx.device.type == "cpu":
        return rnn_tanh_scan_plain(gx, lengths, w_hh, reverse)
    if gx.device.type != "cuda":
        raise ValueError(f"unsupported device {gx.device}")
    _check_operands("gx", gx, lengths, w_hh)
    launch = cuda_build.bind("rnn_tanh_scan", "rnn_tanh_scan_launch", 6, 4)

    t_max, batch, hidden = gx.shape
    dev = gx.device
    h32 = torch.empty((2, batch, hidden), dtype=torch.float32, device=dev)
    h16 = torch.empty((2, batch, hidden), dtype=torch.bfloat16, device=dev)
    h32[0].zero_()
    h16[0].zero_()
    out = torch.empty((t_max, batch, hidden), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            gx.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(),
            h32.data_ptr(), h16.data_ptr(), out.data_ptr(),
            t_max, batch, hidden, int(bool(reverse)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"rnn_tanh_scan launch failed: CUDA error {rc}")
    rnn_tanh_scan.launches += 1
    return out, h32[t_max % 2]  # the buffer the final step wrote


rnn_tanh_scan.launches = 0


def rnn_tanh_bwd_scan_plain(out, dout, lengths, w_hh, reverse: bool = True):
    """The kernel's arithmetic in plain tensor ops, on any device.

    out (T, B, H) is the forward output stream in the stream dtype (zeros
    where t >= length), dout (T, B, H) f32 is dL/d out, w_hh (H, H) in the
    weights' dtype. dL/dh starts at zero. ``reverse=True`` walks t = T-1 .. 0
    (the backward of a forward chain), ``reverse=False`` 0 .. T-1 (the
    backward of a reverse-time chain). Returns (dpre (T, B, H) f32, the
    gradient of the pre-activations; dh0 (B, H) f32). Steps past a row's
    length give zeros and pass dL/dh through. The product takes operands
    rounded to w_hh's dtype and accumulates in f32.
    """
    t_max, batch, hidden = out.shape
    dev = out.device
    mm_dtype = w_hh.dtype
    w_t = w_hh.float().t()
    lengths = lengths.to(dev)
    dh = torch.zeros((batch, hidden), dtype=torch.float32, device=dev)
    dpre = torch.empty((t_max, batch, hidden), dtype=torch.float32, device=dev)
    for t in time_order(t_max, reverse):
        m = (lengths > t).float()[:, None]
        h_new = out[t].float()
        dpre_t = m * (dh + dout[t].float()) * (1.0 - h_new * h_new)
        dpre[t] = dpre_t
        dh = dpre_t.to(mm_dtype).float() @ w_t + (1.0 - m) * dh
    return dpre, dh


def rnn_tanh_bwd_scan(out, dout, lengths, w_hh, reverse: bool = True):
    """The backward walk of one tanh-RNN chain.

    Same contract and return values as :func:`rnn_tanh_bwd_scan_plain`. A
    CUDA ``out`` launches the kernel (bf16 out and w_hh, f32 dout, int32
    lengths, all contiguous on out's device) or raises; a CPU ``out`` runs
    the plain version. ``rnn_tanh_bwd_scan.launches`` counts kernel launches
    (one per call: the T + 1 step kernels of one chain).
    """
    if out.device.type == "cpu":
        return rnn_tanh_bwd_scan_plain(out, dout, lengths, w_hh, reverse)
    if out.device.type != "cuda":
        raise ValueError(f"unsupported device {out.device}")
    _check_operands("out", out, lengths, w_hh)
    check_tensors("out", {
        "out": (out, tuple(out.shape), torch.bfloat16),
        "dout": (dout, tuple(out.shape), torch.float32),
    })
    launch = cuda_build.bind("rnn_tanh_bwd", "rnn_tanh_bwd_launch", 7, 4)

    t_max, batch, hidden = out.shape
    dev = out.device
    w_hht = w_hh.t().contiguous()
    part = torch.empty((2, batch, hidden), dtype=torch.float32, device=dev)
    part[0].zero_()
    dp = torch.empty((2, batch, hidden), dtype=torch.bfloat16, device=dev)
    dp[0].zero_()
    dpre = torch.empty((t_max, batch, hidden), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            out.data_ptr(), dout.data_ptr(), lengths.data_ptr(), w_hht.data_ptr(),
            part.data_ptr(), dp.data_ptr(), dpre.data_ptr(),
            t_max, batch, hidden, int(bool(reverse)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"rnn_tanh_bwd_scan launch failed: CUDA error {rc}")
    rnn_tanh_bwd_scan.launches += 1
    return dpre, part[(t_max + 1) % 2]


rnn_tanh_bwd_scan.launches = 0
