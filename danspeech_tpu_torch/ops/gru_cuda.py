"""GRU kernels and their plain PyTorch versions.

The ports of four kernels of ``danspeech_tpu/ops/pallas_gru.py``:

- :func:`gru_bidi_fused` (``gru_scan_bidi_fused``, ``csrc/gru_bidi_fused.cu``):
  the input projection and both chains of a bidirectional layer, h0 = 0;
- :func:`gru_scan` (``gru_scan``, ``csrc/gru_scan.cu``): one chain over a
  precomputed bias-free projection, with a carried h0 and a ``reverse``
  flag (unidirectional layers and the streaming chunk step);
- :func:`gru_scan_bidi` (``gru_scan_bidi``, ``csrc/gru_scan.cu`` over two
  chains, its step design ``csrc/gru_scan_bidi.cu``): both chains of a
  bidirectional layer over precomputed projections, with carried h0
  (concatenated directions, carried state);
- :func:`gru_bwd_scan` (``gru_bwd_scan``, ``csrc/gru_bwd.cu``): the backward
  walk of one chain for training.

Each source's header note says what bounds it on an H100 and what the
design does about it. Each kernel has two designs: "persistent" (one
cooperative launch walks every step, the weights resident in shared memory,
``csrc/persist.cuh``) and "step" (one launch per time step).
``persist_plan`` chooses between them from the shape
and the device's SM count and shared memory, never after a failed launch;
the ``design=`` argument of the wrappers overrides the choice for checks.

Each wrapper takes two sets of operands, told apart by the dtype of its
sequence: bf16 sequences and weights with f32 biases and states (the
designs above), or everything in float32, which runs the float32 variants of
``csrc/gru_f32.cu``. Their forward walk (B1, B2, B3's recurrence) has both
designs too: "persistent" is one cooperative launch of
``gru_f32_persist_kernel``, each block keeping what fits of its float32 slice
resident and streaming the rest from L2 (:func:`persist_plan.plan_gru_f32_forward`
plans it), "step" one launch per time step. The float32 backward walk (B4)
has both too: "persistent" is the FFMA gate recompute, then one cooperative
launch of ``gru_f32_bwd_persist_kernel`` (:func:`persist_plan.plan_gru_f32_backward`),
"step" the recompute and T + 1 step launches. A mixed set raises
``TypeError``.
``<wrapper>.dtype_counts`` counts the CUDA calls by the set taken.

:func:`sgemm_f32` launches on its own the float32 GEMM (``csrc/sgemm.cuh``)
that B3's float32 projection and the gate recompute of B4 and B7 run inside
their C entries, so that it can be checked and timed by itself.

A wrapper launches its kernel for CUDA tensors and raises on anything the
kernel does not take; for CPU tensors, and only for those, it runs the plain
version (dtype-generic). There is no fallback from a failed build or launch
to the plain version.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from . import cuda_build, persist_plan
from .cuda_build import chain_ptrs
from .cuda_checks import check_tensors as _check_tensors
from .cuda_checks import count, pair_dtype
from .precision import full_float32

_device_info: dict[int, tuple[int, int]] = {}

# The most bytes gru_bidi_fused's f32 projection buffer (2, T, rows, 3H) may
# take: a larger batch runs in groups of rows, one launch each. The flagship's
# 128-row group at T = 401 (1.48 GB) stays one launch; 128 one-minute clips
# (T = 3001) would otherwise ask for 11 GB.
GX_BUDGET_BYTES = 2 << 30


def device_info(device: torch.device) -> tuple[int, int]:
    """(SM count, bytes of shared memory one block may opt in to) of a CUDA
    device, as the CUDA runtime reports them."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _device_info:
        fn = cuda_build.load("gru_bwd").persist_device_info
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        fn.restype = ctypes.c_int
        sms, smem = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(index):
            rc = fn(ctypes.byref(sms), ctypes.byref(smem))
        if rc != 0:
            raise RuntimeError(f"persist_device_info failed: CUDA error {rc}")
        _device_info[index] = (sms.value, smem.value)
    return _device_info[index]


_transposes: dict[int, tuple] = {}
_f32_slices: dict[tuple, tuple] = {}
_f32_rows: dict[tuple, tuple] = {}


def _kept(cache: dict, key, w: torch.Tensor, make):
    """``make(w)``, kept in ``cache`` under ``key`` for as long as ``w`` lives
    with the same storage and version counter. A tensor written in place (an
    optimizer step) has a new version and is made again; an inference tensor
    keeps no version and is made at every call."""
    try:
        version = w._version
    except RuntimeError:
        return make(w)
    hit = cache.get(key)
    if (hit is not None and hit[0]() is w and hit[1] == version
            and hit[2] == w.data_ptr()):
        return hit[3]
    made = make(w)
    cache[key] = (weakref.ref(w, lambda _, k=key: cache.pop(k, None)),
                  version, w.data_ptr(), made)
    return made


def transposed(w: torch.Tensor) -> torch.Tensor:
    """``w.t().contiguous()``, kept per weight tensor (:func:`_kept`). The
    persistent ``gru_scan`` and LSTM routes read rows of w_hh^T; remade at
    every call, the 24 MB copies of GPUStreamingRNN's five layers took 12.7%
    of a streaming chunk's device time (PERF.md)."""
    return _kept(_transposes, id(w), w, lambda m: m.t().contiguous())


def f32_slices(w: torch.Tensor, units: int, blocks: int, depth: int) -> torch.Tensor:
    """Float32 w_hh (H, G H) of G gates (the GRU's 3, the LSTM's 4, the
    tanh-RNN's 1) as the persistent float32 forward walks read it: (blocks,
    depth, G * units), block k's column g * units + u at depth d holding
    w_hh[d, g * H + k * units + u], zeros for units past H and depths past
    H, so that any run of depths of a block's slice is contiguous. Kept per
    weight tensor and cut (:func:`_kept`)."""
    def make(m):
        hidden = m.shape[0]
        gates = m.shape[1] // hidden
        packed = m.new_zeros((depth, gates, blocks * units))
        packed[:hidden, :, :hidden] = m.reshape(hidden, gates, hidden)
        return (packed.reshape(depth, gates, blocks, units).permute(2, 0, 1, 3)
                .reshape(blocks, depth, gates * units).contiguous())

    return _kept(_f32_slices, (id(w), units, blocks, depth), w, make)


def f32_rows(w: torch.Tensor, units: int, blocks: int, depth: int) -> torch.Tensor:
    """Float32 w_hh (H, G H) as the persistent float32 backward walks read
    it (the GRU's B4, G = 3; the LSTM's B7, G = 4), the rows of w_hh being
    the columns of w_hh^T: (blocks, depth, units), block k's column u at
    depth d holding w_hh[k * units + u, d], zeros for units past H and
    depths past G H. Kept per weight tensor and cut (:func:`_kept`)."""
    def make(m):
        hidden, width = m.shape
        packed = m.new_zeros((blocks * units, depth))
        packed[:hidden, :width] = m
        return packed.reshape(blocks, units, depth).transpose(1, 2).contiguous()

    return _kept(_f32_rows, (id(w), units, blocks, depth), w, make)


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
    return _check_tensors("x", expect)


def gx_row_groups(t_max: int, batch: int, hidden: int,
                  budget: int | None = None) -> list[slice]:
    """The groups of rows that :func:`gru_bidi_fused` runs one at a time:
    as many rows a group as keep its f32 projection buffer, 2 * T * rows *
    3H * 4 bytes, within ``budget`` (:data:`GX_BUDGET_BYTES`), at least one.
    Rows of a recurrence are independent, so the groups' results, put side
    by side, are the batch's (up to the order of the sums of a matrix
    product whose kernel depends on the rows: the plan's on the card, the
    BLAS's on the CPU)."""
    budget = GX_BUDGET_BYTES if budget is None else budget
    rows = max(1, budget // (2 * t_max * 3 * hidden * 4))
    return [slice(r, min(r + rows, batch)) for r in range(0, batch, rows)]


def gru_bidi_fused(
    x, lengths, w_ih_f, w_ih_b, w_hh_f, w_hh_b, b_ih_f, b_ih_b, b_hh_f, b_hh_b,
    design: str | None = None,
):
    """Both directions of one GRU layer from its raw input, h0 = 0.

    Same contract and return values as :func:`gru_bidi_fused_plain`. A CUDA
    ``x`` launches the kernel (bf16 x and weights, f32 biases, int32
    lengths, all contiguous on x's device; or everything float32, the
    float32 variant) or raises; a CPU ``x`` runs the plain version.
    ``design`` is None (the plan of :func:`persist_plan.plan_gru_forward`
    decides, :func:`persist_plan.plan_gru_f32_forward` for float32),
    "persistent" or "step";
    ``gru_bidi_fused.design_counts`` counts the CUDA calls by the design taken.
    ``gru_bidi_fused.launches`` counts kernel launches (one per call: the
    projection and the recurrence of one layer). The kernel keeps the
    projection in an f32 buffer of 2 * T * B * 3H * 4 bytes; where that
    would exceed :data:`GX_BUDGET_BYTES` (2 GiB) the batch runs in groups of
    rows (:func:`gx_row_groups`), one call each, on either device.
    """
    args = (w_ih_f, w_ih_b, w_hh_f, w_hh_b, b_ih_f, b_ih_b, b_hh_f, b_hh_b)
    groups = gx_row_groups(x.shape[0], x.shape[1], w_hh_f.shape[0])
    if len(groups) > 1:
        parts = [gru_bidi_fused(x[:, g].contiguous(), lengths[g], *args, design=design)
                 for g in groups]
        return (torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1),
                torch.cat([p[2] for p in parts]), torch.cat([p[3] for p in parts]))
    if x.device.type == "cpu":
        return gru_bidi_fused_plain(x, lengths, *args)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    dtype = _check_operands(x, lengths, w_ih_f, w_ih_b, w_hh_f, w_hh_b, args[4:])

    t_max, batch, d_in = x.shape
    hidden = w_hh_f.shape[0]
    dev = x.device
    if dtype == torch.float32:
        planned = persist_plan.plan_gru_f32_forward(hidden, batch, 2, *device_info(dev))
        design = persist_plan.choose(design, planned)
        if design == "persistent":
            result = _bidi_fused_f32_persistent(x, lengths, *args, planned=planned)
        else:
            result = _bidi_fused_f32(x, lengths, *args)
        count(gru_bidi_fused, design, dtype)
        return result
    planned = persist_plan.plan_gru_forward(hidden, batch, *device_info(dev))
    design = persist_plan.choose(design, planned)
    persistent = design == "persistent"
    # gx in f32 for both directions: 1.5 GB at T=401, B=128, H=1200
    gx = torch.empty((2, t_max, batch, 3 * hidden), dtype=torch.float32, device=dev)
    out = torch.empty((2, t_max, batch, hidden), dtype=torch.bfloat16, device=dev)
    if persistent:
        launch = cuda_build.bind("gru_bidi_fused", "gru_bidi_fused_persist_launch", 16, 10)
        # the resident slices are rows of w_hh^T; f32 h is updated in place
        w_f, w_b = w_hh_f.t().contiguous(), w_hh_b.t().contiguous()
        # rows of x that start on 16 bytes: the projection reads both operands
        # depth-contiguous through the copy engine (wgmma), else as they lie
        w_iht = None
        if d_in % 8 == 0 and x.data_ptr() % 16 == 0:
            w_iht = torch.stack([w_ih_f.t(), w_ih_b.t()]).contiguous()
        h32 = torch.zeros((2, batch, hidden), dtype=torch.float32, device=dev)
        h16 = torch.empty((2, 2, batch, hidden), dtype=torch.bfloat16, device=dev)
        barrier = torch.zeros((2,), dtype=torch.int32, device=dev)
        tail = (barrier.data_ptr(), None if w_iht is None else w_iht.data_ptr(),
                t_max, batch, d_in, hidden, planned.units,
                planned.row_groups, planned.stages, planned.chunk_depth,
                planned.blocks_per_dir, planned.smem_bytes)
    else:
        launch = cuda_build.bind("gru_bidi_fused", "gru_bidi_fused_launch", 14, 4)
        w_f, w_b = w_hh_f, w_hh_b
        h32 = torch.zeros((2, 2, batch, hidden), dtype=torch.float32, device=dev)
        h16 = torch.zeros((2, 2, batch, hidden), dtype=torch.bfloat16, device=dev)
        tail = (t_max, batch, d_in, hidden)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            x.data_ptr(), lengths.data_ptr(),
            w_ih_f.data_ptr(), w_ih_b.data_ptr(), w_f.data_ptr(), w_b.data_ptr(),
            b_ih_f.data_ptr(), b_ih_b.data_ptr(),
            b_hh_f.data_ptr(), b_hh_b.data_ptr(),
            gx.data_ptr(), h32.data_ptr(), h16.data_ptr(), out.data_ptr(),
            *tail, stream,
        )
    if rc != 0:
        raise RuntimeError(f"gru_bidi_fused ({design}) launch failed: CUDA error {rc}")
    count(gru_bidi_fused, design, dtype)
    # step design: the buffer the final step wrote
    last = h32 if persistent else h32[t_max % 2]
    return out[0], out[1], last[0], last[1]


def _bidi_fused_f32(x, lengths, w_ih_f, w_ih_b, w_hh_f, w_hh_b, b_ih_f, b_ih_b,
                    b_hh_f, b_hh_b):
    """The float32 variant (``csrc/gru_f32.cu``): the FFMA projection of both
    directions into an f32 gx buffer, then T launches of the step kernel
    over both chains."""
    launch = cuda_build.bind("gru_f32", "gru_f32_bidi_fused_launch", 13, 4)
    t_max, batch, d_in = x.shape
    hidden = w_hh_f.shape[0]
    dev = x.device
    gx = torch.empty((2, t_max, batch, 3 * hidden), dtype=torch.float32, device=dev)
    h32 = torch.zeros((2, 2, batch, hidden), dtype=torch.float32, device=dev)
    out = torch.empty((2, t_max, batch, hidden), dtype=torch.float32, device=dev)
    cuda_build.call(
        launch, "gru_bidi_fused (float32)", dev,
        x.data_ptr(), lengths.data_ptr(), w_ih_f.data_ptr(), w_ih_b.data_ptr(),
        w_hh_f.data_ptr(), w_hh_b.data_ptr(), b_ih_f.data_ptr(), b_ih_b.data_ptr(),
        b_hh_f.data_ptr(), b_hh_b.data_ptr(), gx.data_ptr(), h32.data_ptr(),
        out.data_ptr(), t_max, batch, d_in, hidden)
    sgemm_f32.launches += 1  # the entry's GEMM (csrc/sgemm.cuh)
    last = h32[t_max % 2]  # the buffer the final step wrote
    return out[0], out[1], last[0], last[1]


def _bidi_fused_f32_persistent(x, lengths, w_ih_f, w_ih_b, w_hh_f, w_hh_b, b_ih_f,
                               b_ih_b, b_hh_f, b_hh_b, planned):
    """The float32 variant, persistent (``csrc/gru_f32.cu``): the FFMA
    projection of both directions into an f32 gx buffer, then both chains in
    one cooperative launch of the planned grid."""
    launch = cuda_build.bind("gru_f32", "gru_f32_bidi_fused_persist_launch", 15, 15)
    t_max, batch, d_in = x.shape
    hidden = w_hh_f.shape[0]
    dev = x.device
    slices = [f32_slices(w, planned.units, planned.blocks_per_dir, planned.padded_depth)
              for w in (w_hh_f, w_hh_b)]
    gx = torch.empty((2, t_max, batch, 3 * hidden), dtype=torch.float32, device=dev)
    hx = torch.zeros((2, 2, planned.padded_depth, planned.padded_rows),
                     dtype=torch.float32, device=dev)
    last = torch.empty((2, batch, hidden), dtype=torch.float32, device=dev)
    out = torch.empty((2, t_max, batch, hidden), dtype=torch.float32, device=dev)
    barrier = torch.zeros((1,), dtype=torch.int32, device=dev)
    cuda_build.call(
        launch, "gru_bidi_fused (float32, persistent)", dev,
        x.data_ptr(), lengths.data_ptr(), w_ih_f.data_ptr(), w_ih_b.data_ptr(),
        slices[0].data_ptr(), slices[1].data_ptr(), b_ih_f.data_ptr(), b_ih_b.data_ptr(),
        b_hh_f.data_ptr(), b_hh_b.data_ptr(), gx.data_ptr(), hx.data_ptr(),
        last.data_ptr(), out.data_ptr(), barrier.data_ptr(),
        t_max, batch, d_in, hidden, *planned.c_args())
    sgemm_f32.launches += 1  # the entry's GEMM (csrc/sgemm.cuh)
    return out[0], out[1], last[0], last[1]


gru_bidi_fused.launches = 0
gru_bidi_fused.design_counts = {"persistent": 0, "step": 0}
gru_bidi_fused.dtype_counts = {"bfloat16": 0, "float32": 0}


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
    return _check_tensors("gx", expect)


def gru_scan(gx, lengths, w_hh, b_ih, b_hh, h0, reverse: bool = False,
             design: str | None = None):
    """One GRU chain over a precomputed projection, with a carried h0.

    Same contract and return values as :func:`gru_scan_plain`. A CUDA
    ``gx`` launches the kernel (bf16 gx and w_hh, f32 biases and h0, int32
    lengths, all contiguous on gx's device; or everything float32, the
    float32 variant) or raises; a CPU ``gx`` runs the plain version.
    ``design`` is None (the plan of :func:`persist_plan.plan_gru_scan`
    decides, :func:`persist_plan.plan_gru_f32_forward` for float32),
    "persistent" or "step";
    ``gru_scan.design_counts`` counts the CUDA calls by the design taken.
    ``gru_scan.launches`` counts kernel launches (one per call).
    """
    if gx.device.type == "cpu":
        return gru_scan_plain(gx, lengths, w_hh, b_ih, b_hh, h0, reverse)
    if gx.device.type != "cuda":
        raise ValueError(f"unsupported device {gx.device}")
    dtype = _check_scan_operands(gx, lengths, w_hh, b_ih, b_hh, h0)
    if dtype == torch.float32:
        planned = persist_plan.plan_gru_f32_forward(w_hh.shape[0], gx.shape[1], 1,
                                                    *device_info(gx.device))
        design = persist_plan.choose(design, planned)
        chain = [(gx, lengths, w_hh, b_ih, b_hh, h0)]
        if design == "persistent":
            result = _scan_f32_persistent(chain, [reverse], planned)[0]
        else:
            result = _scan_f32(chain, [reverse])[0]
        count(gru_scan, design, dtype)
        return result
    planned = persist_plan.plan_gru_scan(w_hh.shape[0], gx.shape[1],
                                         *device_info(gx.device))
    design = persist_plan.choose(design, planned)
    if design == "persistent":
        result = _scan_persistent([(gx, lengths, w_hh, b_ih, b_hh, h0)], [reverse],
                                  planned)[0]
    else:
        result = _scan_step(gx, lengths, w_hh, b_ih, b_hh, h0, reverse)
    count(gru_scan, design, dtype)
    return result


gru_scan.launches = 0
gru_scan.design_counts = {"persistent": 0, "step": 0}
gru_scan.dtype_counts = {"bfloat16": 0, "float32": 0}


def _scan_f32(chains, reverses):
    """The float32 variant (``csrc/gru_f32.cu``) over one or two chains that
    share T, B, H and lengths, step design: T launches of the step kernel,
    each chain a slice of the grid. ``chains`` holds (gx, lengths, w_hh,
    b_ih, b_hh, h0) tuples; returns one (out, h_last) per chain."""
    launch = cuda_build.bind("gru_f32", "gru_f32_scan_launch", 12, 6)
    gx, lengths, w_hh = chains[0][:3]
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    dev = gx.device
    n = len(chains)
    h32 = torch.empty((2, n, batch, hidden), dtype=torch.float32, device=dev)
    for k, c in enumerate(chains):
        h32[0, k].copy_(c[5])
    outs = [torch.empty((t_max, batch, hidden), dtype=torch.float32, device=dev)
            for _ in chains]
    cuda_build.call(
        launch, "gru_scan (float32)", dev,
        *chain_ptrs([c[0] for c in chains]), lengths.data_ptr(),
        *chain_ptrs([c[2] for c in chains]), *chain_ptrs([c[3] for c in chains]),
        *chain_ptrs([c[4] for c in chains]), h32.data_ptr(), *chain_ptrs(outs),
        t_max, batch, hidden, int(bool(reverses[0])), int(bool(reverses[-1])), n)
    last = h32[t_max % 2]  # the buffer the final step wrote
    return [(o, last[k]) for k, o in enumerate(outs)]


def _scan_f32_persistent(chains, reverses, planned):
    """The float32 variant, persistent (``csrc/gru_f32.cu``): one or two
    chains that share T, B, H and lengths in one cooperative launch of the
    planned grid. ``chains`` holds (gx, lengths, w_hh, b_ih, b_hh, h0)
    tuples; returns one (out, h_last) per chain."""
    launch = cuda_build.bind("gru_f32", "gru_f32_persist_launch", 15, 17)
    gx, lengths, w_hh = chains[0][:3]
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    dev = gx.device
    n = len(chains)
    hx = torch.zeros((2, n, planned.padded_depth, planned.padded_rows),
                     dtype=torch.float32, device=dev)
    for k, c in enumerate(chains):
        hx[0, k, :hidden, :batch].copy_(c[5].t())  # h0 transposed: rows of units
    slices = [f32_slices(c[2], planned.units, planned.blocks_per_dir, planned.padded_depth)
              for c in chains]
    outs = [(torch.empty((t_max, batch, hidden), dtype=torch.float32, device=dev),
             torch.empty((batch, hidden), dtype=torch.float32, device=dev)) for _ in chains]
    barrier = torch.zeros((1,), dtype=torch.int32, device=dev)
    cuda_build.call(
        launch, "gru_scan (float32, persistent)", dev,
        *chain_ptrs([c[0] for c in chains]), lengths.data_ptr(), *chain_ptrs(slices),
        *chain_ptrs([c[3] for c in chains]), *chain_ptrs([c[4] for c in chains]),
        hx.data_ptr(), *chain_ptrs([o[1] for o in outs]), *chain_ptrs([o[0] for o in outs]),
        barrier.data_ptr(), t_max, batch, hidden, int(bool(reverses[0])),
        int(bool(reverses[-1])), n, *planned.c_args())
    return outs


def _scan_persistent(chains, reverses, planned):
    """One or two chains that share T, B, H and lengths in one cooperative
    launch of the planned grid. ``chains`` holds (gx, lengths, w_hh, b_ih,
    b_hh, h0) tuples; returns one (out, h_last) per chain."""
    launch = cuda_build.bind("gru_scan", "gru_scan_persist_launch", 15, 13)
    gx, lengths, w_hh = chains[0][:3]
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    dev = gx.device
    n = len(chains)
    h16 = torch.empty((2, n, batch, hidden), dtype=torch.bfloat16, device=dev)
    outs, w_hht = [], []
    for k, (_, _, w, _, _, h0) in enumerate(chains):
        h16[0, k].copy_(h0)  # round to nearest even, as __float2bfloat16
        # h0 on entry, updated in place, h_last on exit
        outs.append((torch.empty((t_max, batch, hidden), dtype=torch.bfloat16, device=dev),
                     h0.clone()))
        w_hht.append(transposed(w))  # the resident slices are rows of w_hh^T
    barrier = torch.zeros((n,), dtype=torch.int32, device=dev)

    cuda_build.call(
        launch, "gru_scan (persistent)", dev,
        *chain_ptrs([c[0] for c in chains]), lengths.data_ptr(), *chain_ptrs(w_hht),
        *chain_ptrs([c[3] for c in chains]), *chain_ptrs([c[4] for c in chains]),
        *chain_ptrs([o[1] for o in outs]), h16.data_ptr(), *chain_ptrs([o[0] for o in outs]),
        barrier.data_ptr(), t_max, batch, hidden, int(bool(reverses[0])),
        int(bool(reverses[-1])), n, planned.units, planned.row_groups, planned.stages,
        planned.chunk_depth, planned.blocks_per_dir, planned.smem_bytes,
        int(planned.product == "dot"))
    return outs


def _scan_step(gx, lengths, w_hh, b_ih, b_hh, h0, reverse):
    """T launches of the step kernel."""
    launch = cuda_build.bind("gru_scan", "gru_scan_launch", 8, 4)
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    dev = gx.device
    h32 = torch.empty((2, batch, hidden), dtype=torch.float32, device=dev)
    h16 = torch.empty((2, batch, hidden), dtype=torch.bfloat16, device=dev)
    h32[0].copy_(h0)
    h16[0].copy_(h0)  # round to nearest even, as __float2bfloat16
    out = torch.empty((t_max, batch, hidden), dtype=torch.bfloat16, device=dev)
    cuda_build.call(
        launch, "gru_scan (step)", dev,
        gx.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(),
        b_hh.data_ptr(), h32.data_ptr(), h16.data_ptr(), out.data_ptr(),
        t_max, batch, hidden, int(bool(reverse)))
    return out, h32[t_max % 2]  # the buffer the final step wrote


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


def _scan_bidi_step(gx_f, gx_b, lengths, w_hh_f, w_hh_b, b_ih_f, b_ih_b, b_hh_f,
                    b_hh_b, h0_f, h0_b):
    """T launches of the step kernel, both directions in each."""
    launch = cuda_build.bind("gru_scan_bidi", "gru_scan_bidi_launch", 12, 3)
    t_max, batch, _ = gx_f.shape
    hidden = w_hh_f.shape[0]
    dev = gx_f.device
    h32 = torch.empty((2, 2, batch, hidden), dtype=torch.float32, device=dev)
    h16 = torch.empty((2, 2, batch, hidden), dtype=torch.bfloat16, device=dev)
    for d, h0 in enumerate((h0_f, h0_b)):
        h32[0, d].copy_(h0)
        h16[0, d].copy_(h0)  # round to nearest even, as __float2bfloat16
    out = torch.empty((2, t_max, batch, hidden), dtype=torch.bfloat16, device=dev)
    cuda_build.call(
        launch, "gru_scan_bidi (step)", dev,
        gx_f.data_ptr(), gx_b.data_ptr(), lengths.data_ptr(),
        w_hh_f.data_ptr(), w_hh_b.data_ptr(), b_ih_f.data_ptr(), b_ih_b.data_ptr(),
        b_hh_f.data_ptr(), b_hh_b.data_ptr(), h32.data_ptr(), h16.data_ptr(),
        out.data_ptr(), t_max, batch, hidden)
    last = h32[t_max % 2]  # the buffer the final step wrote
    return out[0], out[1], last[0], last[1]


def scan_bidi_plans(hidden, batch, device, dtype=torch.bfloat16) -> tuple:
    """The plans :func:`gru_scan_bidi` chooses among on ``device`` for the
    operand set ``dtype``: both chains in one persistent launch, else each
    chain in a launch of its own."""
    info = device_info(device)
    if dtype == torch.float32:
        return (persist_plan.plan_gru_f32_forward(hidden, batch, 2, *info),
                persist_plan.plan_gru_f32_forward(hidden, batch, 1, *info))
    return (persist_plan.plan_gru_scan(hidden, batch, *info, chains=2),
            persist_plan.plan_gru_scan(hidden, batch, *info, chains=1))


def gru_scan_bidi(
    gx_f, gx_b, lengths, w_hh_f, w_hh_b, b_ih_f, b_ih_b, b_hh_f, b_hh_b, h0_f, h0_b,
    design: str | None = None,
):
    """Both chains of a bidirectional GRU layer over precomputed
    projections, with carried initial states.

    Same contract and return values as :func:`gru_scan_bidi_plain`. CUDA
    operands launch the kernel (bf16 gx and w_hh, f32 biases and h0, int32
    lengths, all contiguous on gx_f's device; or everything float32, the
    float32 variant) or raise; CPU operands run the plain version.
    ``design`` is None (the plans decide), "persistent" or
    "step". The persistent design is :func:`gru_scan`'s kernel
    (``csrc/gru_scan.cu``; float32: ``gru_f32_persist_kernel``) over two
    chains in one launch where the plan of :func:`persist_plan.plan_gru_scan`
    (:func:`persist_plan.plan_gru_f32_forward`) for two chains fits, else one
    launch a chain where the plan for one does; the step design is
    ``csrc/gru_scan_bidi.cu`` (float32: ``gru_f32_step_kernel``), T launches
    with both directions in each.
    ``gru_scan_bidi.launches`` counts calls (one a call, whatever the
    design); ``gru_scan_bidi.design_counts`` counts them by the design taken.
    """
    args = (gx_f, gx_b, lengths, w_hh_f, w_hh_b, b_ih_f, b_ih_b, b_hh_f, b_hh_b,
            h0_f, h0_b)
    if gx_f.device.type == "cpu":
        return gru_scan_bidi_plain(*args)
    if gx_f.device.type != "cuda":
        raise ValueError(f"unsupported device {gx_f.device}")
    chains = ((gx_f, lengths, w_hh_f, b_ih_f, b_hh_f, h0_f),
              (gx_b, lengths, w_hh_b, b_ih_b, b_hh_b, h0_b))
    dtype = pair_dtype(_check_scan_operands, *chains)
    if gx_b.shape != gx_f.shape or gx_b.device != gx_f.device:
        raise ValueError(
            f"gx_b {tuple(gx_b.shape)} on {gx_b.device} does not match gx_f "
            f"{tuple(gx_f.shape)} on {gx_f.device}"
        )
    if dtype == torch.float32:
        pair, single = scan_bidi_plans(w_hh_f.shape[0], gx_f.shape[1], gx_f.device,
                                       torch.float32)
        planned = pair if pair.design == "persistent" else single
        design = persist_plan.choose(design, planned)
        if design == "step":
            (out_f, hl_f), (out_b, hl_b) = _scan_f32(chains, [False, True])
        elif planned is pair:
            (out_f, hl_f), (out_b, hl_b) = _scan_f32_persistent(chains, [False, True], pair)
        else:
            (out_f, hl_f), = _scan_f32_persistent(chains[:1], [False], single)
            (out_b, hl_b), = _scan_f32_persistent(chains[1:], [True], single)
        count(gru_scan_bidi, design, dtype)
        return out_f, out_b, hl_f, hl_b
    pair, single = scan_bidi_plans(w_hh_f.shape[0], gx_f.shape[1], gx_f.device)
    planned = pair if pair.design == "persistent" else single
    design = persist_plan.choose(design, planned)
    if design == "step":
        result = _scan_bidi_step(*args)
    elif planned is pair:
        (out_f, hl_f), (out_b, hl_b) = _scan_persistent(chains, [False, True], pair)
        result = out_f, out_b, hl_f, hl_b
    else:
        (out_f, hl_f), = _scan_persistent(chains[:1], [False], single)
        (out_b, hl_b), = _scan_persistent(chains[1:], [True], single)
        result = out_f, out_b, hl_f, hl_b
    count(gru_scan_bidi, design, dtype)
    return result


gru_scan_bidi.launches = 0
gru_scan_bidi.design_counts = {"persistent": 0, "step": 0}
gru_scan_bidi.dtype_counts = {"bfloat16": 0, "float32": 0}


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


def _check_bwd_operands(gx, hprev, dout, lengths, w_hh, b_ih, b_hh, dh_last):
    dtype = _check_scan_operands(gx, lengths, w_hh, b_ih, b_hh, dh_last)
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    if (t_max * batch + 127) // 128 > 65535:  # the recompute grid's y limit
        raise ValueError(f"T*B = {t_max * batch} rows exceed the projection grid")
    _check_tensors("gx", {
        "gx": (gx, tuple(gx.shape), torch.bfloat16),
        "hprev": (hprev, (t_max, batch, hidden), torch.bfloat16),
        "dout": (dout, (t_max, batch, hidden), torch.float32),
    })
    return dtype


def _bwd_persistent(chains, reverses, planned):
    """The persistent walk of one or two chains that share T, B, H and
    lengths, in one launch. ``chains`` holds the operand tuples of
    :func:`gru_bwd_scan`; returns one (dgx, dghn, dh0) per chain."""
    launch = cuda_build.bind("gru_bwd", "gru_bwd_persist_launch", 23, 12)
    gx, _, _, lengths, w_hh = chains[0][:5]
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    dev = gx.device
    n = len(chains)
    outs = []
    for c in chains:
        dh0 = c[7].clone()  # dh_last on entry, the carry in place, dh0 on exit
        dgx = torch.empty((t_max, batch, 3 * hidden), dtype=torch.float32, device=dev)
        dghn = torch.empty((t_max, batch, hidden), dtype=torch.float32, device=dev)
        outs.append((dgx, dghn, dh0))
    dgh = torch.empty((2, n, batch, 3 * hidden), dtype=torch.bfloat16, device=dev)
    barrier = torch.zeros((n,), dtype=torch.int32, device=dev)
    # rows of hprev that start on 16 bytes: the gate recompute reads both
    # operands depth-contiguous through the copy engine (wgmma), else as they lie
    w_hht = [None, None]
    if hidden % 8 == 0 and all(c[1].data_ptr() % 16 == 0 for c in chains):
        w_hht = ([transposed(c[4]) for c in chains] * 2)[:2]

    def pair(i, of_outs=False):
        src = outs if of_outs else chains
        return [src[k][i].data_ptr() for k in (0, n - 1)]

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            *pair(0), *pair(1), *pair(2), lengths.data_ptr(), *pair(4), *pair(5),
            *pair(6), *pair(2, True), dgh.data_ptr(), *pair(0, True),
            *pair(1, True), barrier.data_ptr(),
            *(None if w is None else w.data_ptr() for w in w_hht),
            t_max, batch, hidden, int(bool(reverses[0])), int(bool(reverses[-1])),
            n, planned.units, planned.row_groups, planned.stages, planned.chunk_depth,
            planned.blocks_per_dir, planned.smem_bytes, stream,
        )
    if rc != 0:
        raise RuntimeError(f"gru_bwd_scan (persistent) launch failed: CUDA error {rc}")
    return outs


def _bwd_step(gx, hprev, dout, lengths, w_hh, b_ih, b_hh, dh_last, reverse):
    launch = cuda_build.bind("gru_bwd", "gru_bwd_launch", 12, 4)
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    dev = gx.device
    w_hht = transposed(w_hh)
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
        raise RuntimeError(f"gru_bwd_scan (step) launch failed: CUDA error {rc}")
    return dgx, dghn, part[(t_max + 1) % 2]


def gru_bwd_scan(
    gx, hprev, dout, lengths, w_hh, b_ih, b_hh, dh_last, reverse: bool = True,
    design: str | None = None,
):
    """The backward walk of one GRU chain.

    Same contract and return values as :func:`gru_bwd_scan_plain`. A CUDA
    ``gx`` launches the kernel (bf16 gx, hprev and w_hh, f32 dout, biases
    and dh_last, int32 lengths, all contiguous on gx's device; or everything
    float32, the float32 variant) or raises; a CPU ``gx`` runs the plain
    version. ``design`` is None (the plan of
    :func:`persist_plan.plan_gru_backward` decides,
    :func:`persist_plan.plan_gru_f32_backward` for float32), "persistent" or
    "step"; ``gru_bwd_scan.design_counts`` counts the chains by the design
    taken.
    ``gru_bwd_scan.launches`` counts kernel launches (one per chain: the
    gate-recompute product and the walk).
    """
    args = (gx, hprev, dout, lengths, w_hh, b_ih, b_hh, dh_last)
    if gx.device.type == "cpu":
        return gru_bwd_scan_plain(*args, reverse)
    if gx.device.type != "cuda":
        raise ValueError(f"unsupported device {gx.device}")
    dtype = _check_bwd_operands(*args)
    if dtype == torch.float32:
        planned = persist_plan.plan_gru_f32_backward(w_hh.shape[0], gx.shape[1], 1,
                                                     *device_info(gx.device))
        design = persist_plan.choose(design, planned)
        if design == "persistent":
            result = _bwd_f32_persistent([args], [reverse], planned)[0]
        else:
            result = _bwd_f32([args], [reverse])[0]
        count(gru_bwd_scan, design, dtype)
        return result
    planned = persist_plan.plan_gru_backward(
        w_hh.shape[0], gx.shape[1], 1, *device_info(gx.device))
    design = persist_plan.choose(design, planned)
    if design == "persistent":
        result = _bwd_persistent([args], [reverse], planned)[0]
    else:
        result = _bwd_step(*args, reverse)
    count(gru_bwd_scan, design, dtype)
    return result


gru_bwd_scan.launches = 0
gru_bwd_scan.design_counts = {"persistent": 0, "step": 0}
gru_bwd_scan.dtype_counts = {"bfloat16": 0, "float32": 0}


def _bwd_f32(chains, reverses):
    """The float32 variant (``csrc/gru_f32.cu``) of one or two walks that
    share T, B, H and lengths: the FFMA gate recompute of each chain, then
    T + 1 launches of the step kernel, each chain a slice of the grid.
    ``chains`` holds the operand tuples of :func:`gru_bwd_scan`; returns one
    (dgx, dghn, dh0) per chain."""
    launch = cuda_build.bind("gru_f32", "gru_f32_bwd_launch", 19, 6)
    gx, _, _, lengths, w_hh = chains[0][:5]
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    dev = gx.device
    n = len(chains)
    part = torch.empty((2, n, batch, hidden), dtype=torch.float32, device=dev)
    for k, c in enumerate(chains):
        part[0, k].copy_(c[7])  # dh_last
    dgh = torch.zeros((2, n, batch, 3 * hidden), dtype=torch.float32, device=dev)
    dgx = [torch.empty((t_max, batch, 3 * hidden), dtype=torch.float32, device=dev)
           for _ in chains]
    dghn = [torch.empty((t_max, batch, hidden), dtype=torch.float32, device=dev)
            for _ in chains]
    cuda_build.call(
        launch, "gru_bwd_scan (float32)", dev,
        *chain_ptrs([c[0] for c in chains]), *chain_ptrs([c[1] for c in chains]),
        *chain_ptrs([c[2] for c in chains]), lengths.data_ptr(),
        *chain_ptrs([c[4] for c in chains]), *chain_ptrs([c[5] for c in chains]),
        *chain_ptrs([c[6] for c in chains]), part.data_ptr(), dgh.data_ptr(),
        *chain_ptrs(dgx), *chain_ptrs(dghn),
        t_max, batch, hidden, int(bool(reverses[0])), int(bool(reverses[-1])), n)
    sgemm_f32.launches += 1  # the entry's GEMM (csrc/sgemm.cuh)
    last = part[(t_max + 1) % 2]  # the buffer the final step wrote
    return [(dgx[k], dghn[k], last[k]) for k in range(n)]


def _bwd_f32_persistent(chains, reverses, planned):
    """The float32 variant, persistent (``csrc/gru_f32.cu``): the FFMA gate
    recompute of each chain, then one or two walks that share T, B, H and
    lengths in one cooperative launch of the planned grid, each chain with
    its own barrier. ``chains`` holds the operand tuples of
    :func:`gru_bwd_scan`; returns one (dgx, dghn, dh0) per chain."""
    launch = cuda_build.bind("gru_f32", "gru_f32_bwd_persist_launch", 23, 17)
    gx, _, _, lengths, w_hh = chains[0][:5]
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    dev = gx.device
    n = len(chains)
    # dgh of each step, exchanged transposed (depths of 3H, then rows); zeros
    # past 3H and past B are never written
    dg = torch.zeros((2, n, planned.padded_depth, planned.padded_rows), dtype=torch.float32,
                     device=dev)
    rows = [f32_rows(c[4], planned.units, planned.blocks_per_dir, planned.padded_depth)
            for c in chains]
    outs = [(torch.empty((t_max, batch, 3 * hidden), dtype=torch.float32, device=dev),
             torch.empty((t_max, batch, hidden), dtype=torch.float32, device=dev),
             c[7].clone()) for c in chains]  # dh_last on entry, dh0 on exit
    barrier = torch.zeros((n,), dtype=torch.int32, device=dev)
    cuda_build.call(
        launch, "gru_bwd_scan (float32, persistent)", dev,
        *(p for i in range(3) for p in chain_ptrs([c[i] for c in chains])),
        lengths.data_ptr(), *chain_ptrs([c[4] for c in chains]), *chain_ptrs(rows),
        *chain_ptrs([c[5] for c in chains]), *chain_ptrs([c[6] for c in chains]),
        dg.data_ptr(), *chain_ptrs([o[2] for o in outs]), *chain_ptrs([o[0] for o in outs]),
        *chain_ptrs([o[1] for o in outs]), barrier.data_ptr(),
        t_max, batch, hidden, int(bool(reverses[0])), int(bool(reverses[-1])), n,
        *planned.c_args())
    sgemm_f32.launches += 1  # the entry's GEMM (csrc/sgemm.cuh)
    return outs


def gru_bwd_scan_pair(chain_a, chain_b, reverse_a: bool, reverse_b: bool,
                      design: str | None = None):
    """The backward walks of the two chains of a bidirectional layer.

    ``chain_a`` and ``chain_b`` are the operand tuples (gx, hprev, dout,
    lengths, w_hh, b_ih, b_hh, dh_last) of :func:`gru_bwd_scan`, over the
    same lengths tensor and shapes. Returns ((dgx, dghn, dh0) of a, the same
    of b), each as :func:`gru_bwd_scan` would return it. On CUDA both walks
    share one persistent launch when the plan for two chains fits (each
    chain has its own barrier: the step count on the critical path halves);
    otherwise, and for ``design="step"``, they run one after the other as two
    :func:`gru_bwd_scan` calls. Float32 chains take the plans of
    :func:`persist_plan.plan_gru_f32_backward`: both in one cooperative
    launch where the plan for two fits, else one launch a chain where the
    plan for one does; ``design="step"`` (or no plan that fits) walks both
    in each of the T + 1 launches of the float32 step kernel. Either way
    ``gru_bwd_scan.launches`` grows by two: it counts chains.
    """
    if chain_a[0].device.type != "cuda":
        return (gru_bwd_scan(*chain_a, reverse=reverse_a),
                gru_bwd_scan(*chain_b, reverse=reverse_b))
    dtype = pair_dtype(_check_bwd_operands, chain_a, chain_b)
    if chain_a[0].shape != chain_b[0].shape or chain_a[3] is not chain_b[3]:
        raise ValueError("the two chains must share their shapes and lengths")
    if dtype == torch.float32:
        outs, design = persist_plan.run_f32_pair(
            persist_plan.plan_gru_f32_backward, chain_a[4].shape[0], chain_a[0].shape[1],
            device_info(chain_a[0].device), design, [chain_a, chain_b], [reverse_a, reverse_b],
            _bwd_f32, _bwd_f32_persistent)
        count(gru_bwd_scan, design, dtype, 2)
        return outs[0], outs[1]
    planned = persist_plan.plan_gru_backward(
        chain_a[4].shape[0], chain_a[0].shape[1], 2, *device_info(chain_a[0].device))
    if design == "step" or planned.design != "persistent":
        return (gru_bwd_scan(*chain_a, reverse=reverse_a, design=design),
                gru_bwd_scan(*chain_b, reverse=reverse_b, design=design))
    persist_plan.choose(design, planned)
    outs = _bwd_persistent([chain_a, chain_b], [reverse_a, reverse_b], planned)
    count(gru_bwd_scan, "persistent", dtype, 2)
    return outs[0], outs[1]


def sgemm_f32_plain(a, b):
    """``a @ b`` in full float32 (TF32 off on CUDA), on any device: the
    function of :func:`sgemm_f32`."""
    with full_float32(a.device):
        return a @ b


def sgemm_f32(a, b):
    """The float32 GEMM of ``csrc/sgemm.cuh`` on its own: ``a @ b`` for a (M,
    K) or (Z, M, K) and b (K, N) or (Z, K, N), Z 1 or 2, a 2-D operand shared
    by both products (as B3's projection shares x). Returns (M, N), or (Z, M,
    N) where either operand is 3-D. A CUDA ``a`` launches the kernel
    (``gru_f32.cu``'s ``sgemm_f32_launch``: float32, contiguous, both on one
    device) or raises; a CPU ``a`` runs :func:`sgemm_f32_plain`.
    ``sgemm_f32.launches`` counts the GEMM's launches: its own, and the one
    each call of the float32 C entries of B3, B4 and B7 makes.
    """
    if a.device.type == "cpu":
        return sgemm_f32_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    for name, t in (("a", a), ("b", b)):
        if t.device != a.device:
            raise ValueError(f"b is on {b.device}, a on {a.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}, the kernel takes float32")
        if t.dim() not in (2, 3) or (t.dim() == 3 and t.shape[0] not in (1, 2)):
            raise ValueError(f"{name} must be 2-D, or 3-D with 1 or 2 planes; "
                             f"got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    z = max(t.shape[0] if t.dim() == 3 else 1 for t in (a, b))
    if a.dim() == 3 and b.dim() == 3 and a.shape[0] != b.shape[0]:
        raise ValueError(f"a has {a.shape[0]} planes, b {b.shape[0]}")
    m, k = a.shape[-2:]
    k_b, n = b.shape[-2:]
    if k != k_b:
        raise ValueError(f"a is (.., {m}, {k}), b (.., {k_b}, {n}): depths differ")
    if min(m, n, k) < 1 or max(m, n, k) > 2**31 - 1:
        raise ValueError(f"M, N, K = {m}, {n}, {k}: each from 1 to 2**31 - 1")
    out = _sgemm(a, b, z)
    return out if a.dim() == 3 or b.dim() == 3 else out[0]


def _sgemm(a, b, z):
    """One launch of ``sgemm_f32_launch`` over ``z`` products: each operand's
    planes (a 2-D or one-plane operand shared by both), into a new (z, M, N)
    float32 output on a's device."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    out = torch.empty((z, m, n), dtype=torch.float32, device=a.device)

    def planes(t):
        if t.dim() == 3 and t.shape[0] == z:
            return [t[i] for i in range(z)]
        return [t.reshape(t.shape[-2:])] * z

    launch = cuda_build.bind("gru_f32", "sgemm_f32_launch", 6, 4)
    cuda_build.call(launch, "sgemm_f32", a.device, *chain_ptrs(planes(a)),
                    *chain_ptrs(planes(b)), *chain_ptrs(list(out)), m, n, k, z)
    sgemm_f32.launches += 1
    return out


sgemm_f32.launches = 0
