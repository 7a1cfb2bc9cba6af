"""GRU kernels and their plain PyTorch versions.

The ports of two kernels of ``danspeech_tpu/ops/pallas_gru.py``:

- :func:`gru_bidi_fused` (``gru_scan_bidi_fused``, ``csrc/gru_bidi_fused.cu``):
  the input projection and both chains of a bidirectional layer, h0 = 0;
- :func:`gru_scan` (``gru_scan``, ``csrc/gru_scan.cu``): one chain over a
  precomputed bias-free projection, with a carried h0 and a ``reverse``
  flag (unidirectional layers and the streaming chunk step).

Each source's header note says what bounds it on an H100 and what the
design does about it. A wrapper launches its kernel for CUDA tensors and
raises on anything the kernel does not take; for CPU tensors, and only for
those, it runs the plain version. There is no fallback from a failed build
or launch to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build



def gru_bidi_fused_plain(
    x, lengths, w_ih_f, w_ih_b, w_hh_f, w_hh_b, b_ih_f, b_ih_b, b_hh_f, b_hh_b
):
    """The kernel's arithmetic in plain tensor ops, on any device.

    x (T, B, D) in the stream dtype (bf16 on the serving path), w_ih (D, 3H)
    and w_hh (H, 3H) in the weights' dtype, biases (3H,) f32, lengths (B,).
    Returns (out_f, out_b, h_last_f, h_last_b): outputs (T, B, H) in x's
    dtype with exact zeros where t >= length, h_last (B, H) f32.

    Products take operands rounded to their dtype and accumulate in f32
    (the operands are upcast before each product: a bf16 matmul on the CPU
    would round its result to bf16, unlike JAX's preferred_element_type).
    """
    t_max, batch, d_in = x.shape
    hidden = w_hh_f.shape[0]
    g3 = 3 * hidden
    dev = x.device
    xf = x.reshape(t_max * batch, d_in).float()
    gx = torch.stack(
        [
            (xf @ w_ih_f.float()).reshape(t_max, batch, g3),
            (xf @ w_ih_b.float()).reshape(t_max, batch, g3),
        ]
    )  # (2, T, B, 3H) f32, bias-free
    w_hh = torch.stack([w_hh_f, w_hh_b])  # (2, H, 3H)
    mm_dtype = w_hh.dtype
    w_hh = w_hh.float()
    b_ih = torch.stack([b_ih_f, b_ih_b]).float()[:, None, :]
    b_hh = torch.stack([b_hh_f, b_hh_b]).float()[:, None, :]
    lengths = lengths.to(dev)

    h = torch.zeros((2, batch, hidden), dtype=torch.float32, device=dev)
    out = torch.empty((2, t_max, batch, hidden), dtype=x.dtype, device=dev)
    for s in range(t_max):
        tb = t_max - 1 - s  # the backward chain walks time in reverse
        gx_t = torch.stack([gx[0, s], gx[1, tb]]) + b_ih
        gh = torch.bmm(h.to(mm_dtype).float(), w_hh) + b_hh
        r = torch.sigmoid(gx_t[..., :hidden] + gh[..., :hidden])
        z = torch.sigmoid(
            gx_t[..., hidden : 2 * hidden] + gh[..., hidden : 2 * hidden]
        )
        n = torch.tanh(gx_t[..., 2 * hidden :] + r * gh[..., 2 * hidden :])
        h_new = (1.0 - z) * n + z * h
        valid = torch.stack([lengths > s, lengths > tb])[..., None]  # (2, B, 1)
        h = torch.where(valid, h_new, h)
        o = torch.where(valid, h_new, torch.zeros_like(h_new)).to(x.dtype)
        out[0, s] = o[0]
        out[1, tb] = o[1]
    return out[0], out[1], h[0], h[1]


def _check_operands(x, lengths, w_ih_f, w_ih_b, w_hh_f, w_hh_b, biases):
    if x.dim() != 3:
        raise ValueError(f"x must be (T, B, D), got shape {tuple(x.shape)}")
    t_max, batch, d_in = x.shape
    if t_max == 0 or batch == 0:
        raise ValueError(f"empty input: x shape {tuple(x.shape)}")
    if (t_max * batch + 127) // 128 > 65535:  # the projection grid's y limit
        raise ValueError(f"T*B = {t_max * batch} rows exceed the projection grid")
    hidden = w_hh_f.shape[0]
    expect = {
        "w_ih_f": (w_ih_f, (d_in, 3 * hidden), torch.bfloat16),
        "w_ih_b": (w_ih_b, (d_in, 3 * hidden), torch.bfloat16),
        "w_hh_f": (w_hh_f, (hidden, 3 * hidden), torch.bfloat16),
        "w_hh_b": (w_hh_b, (hidden, 3 * hidden), torch.bfloat16),
        "x": (x, (t_max, batch, d_in), torch.bfloat16),
        "lengths": (lengths, (batch,), torch.int32),
    }
    for name, b in zip(("b_ih_f", "b_ih_b", "b_hh_f", "b_hh_b"), biases):
        expect[name] = (b, (3 * hidden,), torch.float32)
    for name, (t, shape, dtype) in expect.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype:
            raise TypeError(
                f"{name} is {t.dtype}, the kernel takes {dtype} (the float32 "
                "GRU kernel is not ported yet)"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _bind_bidi_fused():
    lib = cuda_build.load("gru_bidi_fused")
    fn = lib.gru_bidi_fused_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def gru_bidi_fused(
    x, lengths, w_ih_f, w_ih_b, w_hh_f, w_hh_b, b_ih_f, b_ih_b, b_hh_f, b_hh_b
):
    """Both directions of one GRU layer from its raw input, h0 = 0.

    Same contract and return values as :func:`gru_bidi_fused_plain`. A CUDA
    ``x`` launches the kernel (bf16 x and weights, f32 biases, int32
    lengths, all contiguous on x's device) or raises; a CPU ``x`` runs the
    plain version. ``gru_bidi_fused.launches`` counts kernel launches (one
    per call: the projection and the T step kernels of one layer).
    """
    args = (w_ih_f, w_ih_b, w_hh_f, w_hh_b, b_ih_f, b_ih_b, b_hh_f, b_hh_b)
    if x.device.type == "cpu":
        return gru_bidi_fused_plain(x, lengths, *args)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_operands(x, lengths, w_ih_f, w_ih_b, w_hh_f, w_hh_b, args[4:])
    launch = _bind_bidi_fused()

    t_max, batch, d_in = x.shape
    hidden = w_hh_f.shape[0]
    dev = x.device
    # gx in f32 for both directions: 1.5 GB at T=401, B=128, H=1200
    gx = torch.empty((2, t_max, batch, 3 * hidden), dtype=torch.float32, device=dev)
    h32 = torch.zeros((2, 2, batch, hidden), dtype=torch.float32, device=dev)
    h16 = torch.zeros((2, 2, batch, hidden), dtype=torch.bfloat16, device=dev)
    out = torch.empty((2, t_max, batch, hidden), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            x.data_ptr(), lengths.data_ptr(),
            w_ih_f.data_ptr(), w_ih_b.data_ptr(),
            w_hh_f.data_ptr(), w_hh_b.data_ptr(),
            b_ih_f.data_ptr(), b_ih_b.data_ptr(),
            b_hh_f.data_ptr(), b_hh_b.data_ptr(),
            gx.data_ptr(), h32.data_ptr(), h16.data_ptr(), out.data_ptr(),
            t_max, batch, d_in, hidden, stream,
        )
    if rc != 0:
        raise RuntimeError(f"gru_bidi_fused launch failed: CUDA error {rc}")
    gru_bidi_fused.launches += 1
    last = h32[t_max % 2]  # the buffer the final step wrote
    return out[0], out[1], last[0], last[1]


gru_bidi_fused.launches = 0


# ---------------------------------------------------------------------------
# gru_scan: one chain over a precomputed projection
# ---------------------------------------------------------------------------


def gru_scan_plain(gx, lengths, w_hh, b_ih, b_hh, h0, reverse: bool = False):
    """The kernel's arithmetic in plain tensor ops, on any device.

    gx (T, B, 3H) is the bias-free projection in the stream dtype, w_hh
    (H, 3H) in the weights' dtype, b_ih and b_hh (3H,) f32 (b_ih is added
    to gx here, b_hh_n stays inside the reset product), h0 (B, H) f32,
    lengths (B,). Returns (out (T, B, H) in gx's dtype with exact zeros
    where t >= length, h_last (B, H) f32). ``reverse`` walks t = T-1 .. 0
    and holds h at h0 until t < length, so its h_last is the state at t = 0.
    The product takes h rounded to w_hh's dtype and accumulates in f32
    (both operands upcast first, as in :func:`gru_bidi_fused_plain`).
    """
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    dev = gx.device
    mm_dtype = w_hh.dtype
    w = w_hh.float()
    b_ih = b_ih.float()
    b_hh = b_hh.float()
    lengths = lengths.to(dev)
    h = h0.float()
    out = torch.empty((t_max, batch, hidden), dtype=gx.dtype, device=dev)
    for t in (range(t_max - 1, -1, -1) if reverse else range(t_max)):
        x = gx[t].float() + b_ih
        gh = h.to(mm_dtype).float() @ w + b_hh
        r = torch.sigmoid(x[:, :hidden] + gh[:, :hidden])
        z = torch.sigmoid(x[:, hidden : 2 * hidden] + gh[:, hidden : 2 * hidden])
        n = torch.tanh(x[:, 2 * hidden :] + r * gh[:, 2 * hidden :])
        h_new = (1.0 - z) * n + z * h
        valid = (lengths > t)[:, None]
        h = torch.where(valid, h_new, h)
        out[t] = torch.where(valid, h_new, torch.zeros_like(h_new)).to(gx.dtype)
    return out, h


def _check_scan_operands(gx, lengths, w_hh, b_ih, b_hh, h0):
    if gx.dim() != 3:
        raise ValueError(f"gx must be (T, B, 3H), got shape {tuple(gx.shape)}")
    t_max, batch, g3 = gx.shape
    if t_max == 0 or batch == 0:
        raise ValueError(f"empty input: gx shape {tuple(gx.shape)}")
    if w_hh.dim() != 2:
        raise ValueError(f"w_hh must be (H, 3H), got shape {tuple(w_hh.shape)}")
    hidden = w_hh.shape[0]
    expect = {
        "gx": (gx, (t_max, batch, 3 * hidden), torch.bfloat16),
        "lengths": (lengths, (batch,), torch.int32),
        "w_hh": (w_hh, (hidden, 3 * hidden), torch.bfloat16),
        "b_ih": (b_ih, (3 * hidden,), torch.float32),
        "b_hh": (b_hh, (3 * hidden,), torch.float32),
        "h0": (h0, (batch, hidden), torch.float32),
    }
    for name, (t, shape, dtype) in expect.items():
        if t.device != gx.device:
            raise ValueError(f"{name} is on {t.device}, gx on {gx.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype:
            raise TypeError(
                f"{name} is {t.dtype}, the kernel takes {dtype} (the GRU "
                "kernels take bf16 sequences and weights only, ROADMAP A6b)"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _bind_scan():
    lib = cuda_build.load("gru_scan")
    fn = lib.gru_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def gru_scan(gx, lengths, w_hh, b_ih, b_hh, h0, reverse: bool = False):
    """One GRU chain over a precomputed projection, with a carried h0.

    Same contract and return values as :func:`gru_scan_plain`. A CUDA
    ``gx`` launches the kernel (bf16 gx and w_hh, f32 biases and h0, int32
    lengths, all contiguous on gx's device) or raises; a CPU ``gx`` runs the
    plain version. ``gru_scan.launches`` counts kernel launches (one per
    call: the T step kernels of one chain).
    """
    if gx.device.type == "cpu":
        return gru_scan_plain(gx, lengths, w_hh, b_ih, b_hh, h0, reverse)
    if gx.device.type != "cuda":
        raise ValueError(f"unsupported device {gx.device}")
    _check_scan_operands(gx, lengths, w_hh, b_ih, b_hh, h0)
    launch = _bind_scan()

    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    dev = gx.device
    h32 = torch.empty((2, batch, hidden), dtype=torch.float32, device=dev)
    h16 = torch.empty((2, batch, hidden), dtype=torch.bfloat16, device=dev)
    h32[0].copy_(h0)
    h16[0].copy_(h0)  # round to nearest even, as __float2bfloat16
    out = torch.empty((t_max, batch, hidden), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            gx.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(),
            b_ih.data_ptr(), b_hh.data_ptr(),
            h32.data_ptr(), h16.data_ptr(), out.data_ptr(),
            t_max, batch, hidden, int(bool(reverse)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"gru_scan launch failed: CUDA error {rc}")
    gru_scan.launches += 1
    return out, h32[t_max % 2]


gru_scan.launches = 0
