"""GRU kernels and their plain PyTorch versions.

The ports of four kernels of ``danspeech_tpu/ops/pallas_gru.py``:

- :func:`gru_bidi_fused` (``gru_scan_bidi_fused``, ``csrc/gru_bidi_fused.cu``):
  the input projection and both chains of a bidirectional layer, h0 = 0;
- :func:`gru_scan` (``gru_scan``, ``csrc/gru_scan.cu``): one chain over a
  precomputed bias-free projection, with a carried h0 and a ``reverse``
  flag (unidirectional layers and the streaming chunk step);
- :func:`gru_scan_bidi` (``gru_scan_bidi``, ``csrc/gru_scan_bidi.cu``): both
  chains of a bidirectional layer over precomputed projections, with
  carried h0 (concatenated directions, carried state);
- :func:`gru_bwd_scan` (``gru_bwd_scan``, ``csrc/gru_bwd.cu``): the backward
  walk of one chain for training.

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
from .cuda_checks import check_tensors as _check_tensors


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
        "x": (x, (t_max, batch, d_in), torch.bfloat16),
        "w_ih_f": (w_ih_f, (d_in, 3 * hidden), torch.bfloat16),
        "w_ih_b": (w_ih_b, (d_in, 3 * hidden), torch.bfloat16),
        "w_hh_f": (w_hh_f, (hidden, 3 * hidden), torch.bfloat16),
        "w_hh_b": (w_hh_b, (hidden, 3 * hidden), torch.bfloat16),
        "lengths": (lengths, (batch,), torch.int32),
    }
    for name, b in zip(("b_ih_f", "b_ih_b", "b_hh_f", "b_hh_b"), biases):
        expect[name] = (b, (3 * hidden,), torch.float32)
    _check_tensors("x", expect)


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
    _check_tensors("gx", expect)


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


# ---------------------------------------------------------------------------
# gru_scan_bidi: both chains over precomputed projections
# ---------------------------------------------------------------------------


def gru_scan_bidi_plain(
    gx_f, gx_b, lengths, w_hh_f, w_hh_b, b_ih_f, b_ih_b, b_hh_f, b_hh_b, h0_f, h0_b
):
    """The kernel's arithmetic in plain tensor ops, on any device: the
    forward chain and the reverse-time chain of :func:`gru_scan_plain`.

    gx_f, gx_b (T, B, 3H) are the bias-free projections of the two
    directions in natural time order (stream dtype), h0_f, h0_b (B, H) f32.
    Returns (out_f, out_b, h_last_f, h_last_b) as :func:`gru_bidi_fused_plain`.
    """
    out_f, hl_f = gru_scan_plain(gx_f, lengths, w_hh_f, b_ih_f, b_hh_f, h0_f)
    out_b, hl_b = gru_scan_plain(
        gx_b, lengths, w_hh_b, b_ih_b, b_hh_b, h0_b, reverse=True
    )
    return out_f, out_b, hl_f, hl_b


def _bind_scan_bidi():
    lib = cuda_build.load("gru_scan_bidi")
    fn = lib.gru_scan_bidi_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def gru_scan_bidi(
    gx_f, gx_b, lengths, w_hh_f, w_hh_b, b_ih_f, b_ih_b, b_hh_f, b_hh_b, h0_f, h0_b
):
    """Both chains of a bidirectional GRU layer over precomputed
    projections, with carried initial states.

    Same contract and return values as :func:`gru_scan_bidi_plain`. CUDA
    operands launch the kernel (bf16 gx and w_hh, f32 biases and h0, int32
    lengths, all contiguous on gx_f's device) or raise; CPU operands run the
    plain version. ``gru_scan_bidi.launches`` counts kernel launches (one per
    call: the T step kernels of one layer, both directions in each).
    """
    args = (gx_f, gx_b, lengths, w_hh_f, w_hh_b, b_ih_f, b_ih_b, b_hh_f, b_hh_b,
            h0_f, h0_b)
    if gx_f.device.type == "cpu":
        return gru_scan_bidi_plain(*args)
    if gx_f.device.type != "cuda":
        raise ValueError(f"unsupported device {gx_f.device}")
    for gx, w_hh, b_ih, b_hh, h0 in (
        (gx_f, w_hh_f, b_ih_f, b_hh_f, h0_f), (gx_b, w_hh_b, b_ih_b, b_hh_b, h0_b)
    ):
        _check_scan_operands(gx, lengths, w_hh, b_ih, b_hh, h0)
    if gx_b.shape != gx_f.shape or gx_b.device != gx_f.device:
        raise ValueError(
            f"gx_b {tuple(gx_b.shape)} on {gx_b.device} does not match gx_f "
            f"{tuple(gx_f.shape)} on {gx_f.device}"
        )
    launch = _bind_scan_bidi()

    t_max, batch, _ = gx_f.shape
    hidden = w_hh_f.shape[0]
    dev = gx_f.device
    h32 = torch.empty((2, 2, batch, hidden), dtype=torch.float32, device=dev)
    h16 = torch.empty((2, 2, batch, hidden), dtype=torch.bfloat16, device=dev)
    for d, h0 in enumerate((h0_f, h0_b)):
        h32[0, d].copy_(h0)
        h16[0, d].copy_(h0)  # round to nearest even, as __float2bfloat16
    out = torch.empty((2, t_max, batch, hidden), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            gx_f.data_ptr(), gx_b.data_ptr(), lengths.data_ptr(),
            w_hh_f.data_ptr(), w_hh_b.data_ptr(),
            b_ih_f.data_ptr(), b_ih_b.data_ptr(),
            b_hh_f.data_ptr(), b_hh_b.data_ptr(),
            h32.data_ptr(), h16.data_ptr(), out.data_ptr(),
            t_max, batch, hidden, stream,
        )
    if rc != 0:
        raise RuntimeError(f"gru_scan_bidi launch failed: CUDA error {rc}")
    gru_scan_bidi.launches += 1
    last = h32[t_max % 2]
    return out[0], out[1], last[0], last[1]


gru_scan_bidi.launches = 0


# ---------------------------------------------------------------------------
# gru_bwd_scan: the backward walk of one chain
# ---------------------------------------------------------------------------


def gru_bwd_scan_plain(
    gx, hprev, dout, lengths, w_hh, b_ih, b_hh, dh_last, reverse: bool = True
):
    """The kernel's arithmetic in plain tensor ops, on any device.

    gx (T, B, 3H) is the bias-free projection and hprev (T, B, H) the state
    before each step in chain order, both in the stream dtype and natural
    time order; dout (T, B, H) f32 is dL/d out; w_hh (H, 3H) in the weights'
    dtype; b_ih, b_hh (3H,) f32; dh_last (B, H) f32 is dL/d h_last.
    ``reverse=True`` walks t = T-1 .. 0 (the backward of a forward chain),
    ``reverse=False`` 0 .. T-1 (the backward of a reverse-time chain).
    Returns (dgx (T, B, 3H) f32, the gradient of the gate pre-activations
    with respect to gx; dghn (T, B, H) f32, the n part of the gradient with
    respect to gh, whose r and z parts equal dgx's; dh0 (B, H) f32). Steps
    past a row's length give zeros and pass dL/dh through. Both products
    take operands rounded to w_hh's dtype and accumulate in f32.
    """
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    dev = gx.device
    mm_dtype = w_hh.dtype
    w = w_hh.float()
    w_t = w.t()
    b_ih = b_ih.float()
    b_hh = b_hh.float()
    lengths = lengths.to(dev)
    dh = dh_last.float()
    dgx = torch.empty((t_max, batch, 3 * hidden), dtype=torch.float32, device=dev)
    dghn = torch.empty((t_max, batch, hidden), dtype=torch.float32, device=dev)
    for t in (range(t_max - 1, -1, -1) if reverse else range(t_max)):
        m = (lengths > t).float()[:, None]
        hp = hprev[t].float()
        x = gx[t].float() + b_ih
        gh = hp.to(mm_dtype).float() @ w + b_hh
        r = torch.sigmoid(x[:, :hidden] + gh[:, :hidden])
        z = torch.sigmoid(x[:, hidden : 2 * hidden] + gh[:, hidden : 2 * hidden])
        gh_n = gh[:, 2 * hidden :]
        n = torch.tanh(x[:, 2 * hidden :] + r * gh_n)

        dhnew = m * (dh + dout[t].float())
        dpre_n = dhnew * (1.0 - z) * (1.0 - n * n)
        dpre_r = dpre_n * gh_n * r * (1.0 - r)
        dpre_z = dhnew * (hp - n) * z * (1.0 - z)
        dghn_t = dpre_n * r
        dgx[t] = torch.cat([dpre_r, dpre_z, dpre_n], dim=-1)
        dghn[t] = dghn_t
        dgh = torch.cat([dpre_r, dpre_z, dghn_t], dim=-1)
        dh = dhnew * z + dgh.to(mm_dtype).float() @ w_t + (1.0 - m) * dh
    return dgx, dghn, dh


def _bind_bwd():
    lib = cuda_build.load("gru_bwd")
    fn = lib.gru_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def gru_bwd_scan(
    gx, hprev, dout, lengths, w_hh, b_ih, b_hh, dh_last, reverse: bool = True
):
    """The backward walk of one GRU chain.

    Same contract and return values as :func:`gru_bwd_scan_plain`. A CUDA
    ``gx`` launches the kernel (bf16 gx, hprev and w_hh, f32 dout, biases
    and dh_last, int32 lengths, all contiguous on gx's device) or raises; a
    CPU ``gx`` runs the plain version. ``gru_bwd_scan.launches`` counts
    kernel launches (one per call: the gate-recompute product and the T + 1
    step kernels of one chain).
    """
    if gx.device.type == "cpu":
        return gru_bwd_scan_plain(
            gx, hprev, dout, lengths, w_hh, b_ih, b_hh, dh_last, reverse
        )
    if gx.device.type != "cuda":
        raise ValueError(f"unsupported device {gx.device}")
    _check_scan_operands(gx, lengths, w_hh, b_ih, b_hh, dh_last)
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    if (t_max * batch + 127) // 128 > 65535:  # the recompute grid's y limit
        raise ValueError(f"T*B = {t_max * batch} rows exceed the projection grid")
    _check_tensors("gx", {
        "gx": (gx, tuple(gx.shape), torch.bfloat16),
        "hprev": (hprev, (t_max, batch, hidden), torch.bfloat16),
        "dout": (dout, (t_max, batch, hidden), torch.float32),
    })
    launch = _bind_bwd()

    dev = gx.device
    w_hht = w_hh.t().contiguous()
    part = torch.empty((2, batch, hidden), dtype=torch.float32, device=dev)
    part[0].copy_(dh_last)
    dgh = torch.empty((2, batch, 3 * hidden), dtype=torch.bfloat16, device=dev)
    dgh[0].zero_()
    dgx = torch.empty((t_max, batch, 3 * hidden), dtype=torch.float32, device=dev)
    dghn = torch.empty((t_max, batch, hidden), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            gx.data_ptr(), hprev.data_ptr(), dout.data_ptr(), lengths.data_ptr(),
            w_hh.data_ptr(), w_hht.data_ptr(), b_ih.data_ptr(), b_hh.data_ptr(),
            part.data_ptr(), dgh.data_ptr(), dgx.data_ptr(), dghn.data_ptr(),
            t_max, batch, hidden, int(bool(reverse)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"gru_bwd_scan launch failed: CUDA error {rc}")
    gru_bwd_scan.launches += 1
    return dgx, dghn, part[(t_max + 1) % 2]


gru_bwd_scan.launches = 0
