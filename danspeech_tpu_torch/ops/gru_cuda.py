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
  walk of one chain for training; :func:`gru_bwd_scan_pair` walks both
  chains of a bidirectional layer.

Each source's header note says what bounds it on an H100 and what the
design does about it. Each kernel has two designs: "persistent" (one
cooperative launch walks every step, the weights resident in shared memory,
``csrc/persist.cuh``) and "step" (one launch per time step). Each wrapper
takes two sets of operands, told apart by the dtype of its sequence: bf16
sequences and weights with f32 biases and states, or everything in float32,
which runs the float32 variants of ``csrc/gru_f32.cu`` (B1, B2 and B3's
recurrence: ``gru_f32_persist_kernel``, each block keeping what fits of its
float32 slice resident and streaming the rest from L2, or one launch a
step; B4: the FFMA gate recompute, then ``gru_f32_bwd_persist_kernel`` or
T + 1 step launches). A mixed set raises ``TypeError``.

Every wrapper describes its kernel once (:data:`GRU_SCAN`, ...) and hands
its chains to :func:`walks.run`, which runs the plain version for CPU
tensors, and only for those, and on the card checks the operands (bf16 or
float32 as above, int32 lengths, contiguous, on one device), plans the
design from the shape and the card, never after a failed launch, takes
``design=`` ("persistent" or "step") as an override for checks, launches and
counts. There is no fallback from a failed build or launch to the plain
version.

:func:`sgemm_f32` launches on its own the float32 GEMM (``csrc/sgemm.cuh``)
that B3's float32 projection and the gate recompute of B4 and B7 run inside
their C entries, so that it can be checked and timed by itself.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch

from . import cuda_build, persist_plan, walks
from .cuda_build import chain_ptrs
from .cuda_checks import check_tensors as _check_tensors
from .precision import full_float32

# The most bytes gru_bidi_fused's f32 projection buffer (2, T, rows, 3H) may
# take: a larger batch runs in groups of rows, one launch each. The flagship's
# 128-row group at T = 401 (1.48 GB) stays one launch; 128 one-minute clips
# (T = 3001) would otherwise ask for 11 GB.
GX_BUDGET_BYTES = 2 << 30


_transposes: dict[int, tuple] = {}
_stacked: dict[tuple, tuple] = {}
_f32_slices: dict[tuple, tuple] = {}
_f32_rows: dict[tuple, tuple] = {}


def _kept(cache: dict, key, ws, make):
    """``make(*ws)`` for a tensor or a tuple of them, kept in ``cache`` under
    ``key`` for as long as each lives with the same storage and version
    counter. A tensor written in place (an optimizer step) has a new version
    and the result is made again, and a tensor freed drops it; an inference
    tensor keeps no version and is made at every call."""
    ws = ws if isinstance(ws, tuple) else (ws,)
    try:
        stamp = tuple((w._version, w.data_ptr()) for w in ws)
    except RuntimeError:
        return make(*ws)
    hit = cache.get(key)
    if hit is not None and all(r() is w for r, w in zip(hit[0], ws)) and hit[1] == stamp:
        return hit[2]
    made = make(*ws)
    cache[key] = (tuple(weakref.ref(w, lambda _, k=key: cache.pop(k, None)) for w in ws),
                  stamp, made)
    return made


def transposed(w: torch.Tensor) -> torch.Tensor:
    """``w.t().contiguous()``, kept per weight tensor (:func:`_kept`). The
    persistent routes of B1, B2, B3 and the LSTM read rows of w_hh^T; remade
    at every call, the 24 MB copies of GPUStreamingRNN's five layers took
    12.7% of a streaming chunk's device time (PERF.md)."""
    return _kept(_transposes, id(w), w, lambda m: m.t().contiguous())


def stacked_transposes(w_f: torch.Tensor, w_b: torch.Tensor) -> torch.Tensor:
    """``torch.stack([w_f.t(), w_b.t()]).contiguous()``: the w_ih^T of both
    directions that B3's persistent projection reads, kept per pair of
    tensors (:func:`_kept`)."""
    return _kept(_stacked, (id(w_f), id(w_b)), (w_f, w_b),
                 lambda f, b: torch.stack([f.t(), b.t()]).contiguous())


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
    """Both directions of one GRU layer from its raw input, h0 = 0:
    :func:`gru_bidi_fused_plain`, one launch a call on the card (the
    projection and the recurrence), planned by
    :func:`persist_plan.plan_gru_forward` (float32:
    :func:`persist_plan.plan_gru_f32_forward`). The kernel keeps the
    projection in an f32 buffer of 2 * T * B * 3H * 4 bytes; where that would
    exceed :data:`GX_BUDGET_BYTES` (2 GiB) the batch runs in groups of rows
    (:func:`gx_row_groups`), one call each, on either device."""
    args = (w_ih_f, w_ih_b, w_hh_f, w_hh_b, b_ih_f, b_ih_b, b_hh_f, b_hh_b)
    groups = gx_row_groups(x.shape[0], x.shape[1], w_hh_f.shape[0])
    if len(groups) > 1:
        parts = [gru_bidi_fused(x[:, g].contiguous(), lengths[g], *args, design=design)
                 for g in groups]
        return (torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1),
                torch.cat([p[2] for p in parts]), torch.cat([p[3] for p in parts]))
    return walks.run(GRU_BIDI_FUSED, [(x, lengths, *args)], [False], design)[0]


def _bidi_fused(x, lengths, w_ih_f, w_ih_b, w_hh_f, w_hh_b, b_ih_f, b_ih_b, b_hh_f,
                b_hh_b, planned=None):
    """The bf16 kernel: the projection of both directions into an f32 gx
    buffer, then both chains in one cooperative launch of the ``planned``
    grid, or (``planned`` None) T launches of the step kernel."""
    t_max, batch, d_in = x.shape
    hidden = w_hh_f.shape[0]
    dev = x.device
    # gx in f32 for both directions: 1.5 GB at T=401, B=128, H=1200
    gx = torch.empty((2, t_max, batch, 3 * hidden), dtype=torch.float32, device=dev)
    out = torch.empty((2, t_max, batch, hidden), dtype=torch.bfloat16, device=dev)
    if planned is not None:
        launch = cuda_build.bind("gru_bidi_fused", "gru_bidi_fused_persist_launch", 16, 10)
        # the resident slices are rows of w_hh^T; f32 h is updated in place
        w_f, w_b = transposed(w_hh_f), transposed(w_hh_b)
        # rows of x that start on 16 bytes: the projection reads both operands
        # depth-contiguous through the copy engine (wgmma), else as they lie
        w_iht = None
        if d_in % 8 == 0 and x.data_ptr() % 16 == 0:
            w_iht = stacked_transposes(w_ih_f, w_ih_b)
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
    cuda_build.call(
        launch, f"gru_bidi_fused ({'step' if planned is None else 'persistent'})", dev,
        x.data_ptr(), lengths.data_ptr(),
        w_ih_f.data_ptr(), w_ih_b.data_ptr(), w_f.data_ptr(), w_b.data_ptr(),
        b_ih_f.data_ptr(), b_ih_b.data_ptr(), b_hh_f.data_ptr(), b_hh_b.data_ptr(),
        gx.data_ptr(), h32.data_ptr(), h16.data_ptr(), out.data_ptr(), *tail)
    # step design: the buffer the final step wrote
    last = h32 if planned is not None else h32[t_max % 2]
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


GRU_BIDI_FUSED = walks.Walk(
    check=lambda x, lengths, *w: _check_operands(x, lengths, *w[:4], w[4:]),
    plain=lambda *layer, reverse: gru_bidi_fused_plain(*layer),
    plan=lambda h, b, chains, *info: persist_plan.plan_gru_forward(h, b, *info),
    plan_f32=lambda h, b, chains, *info: persist_plan.plan_gru_f32_forward(h, b, 2, *info),
    persistent=lambda layers, r, planned: [_bidi_fused(*layers[0], planned=planned)],
    step=lambda layers, r: [_bidi_fused(*layers[0])],
    persistent_f32=lambda layers, r, planned: [
        _bidi_fused_f32_persistent(*layers[0], planned=planned)],
    step_f32=lambda layers, r: [_bidi_fused_f32(*layers[0])],
    counter=walks.counted(gru_bidi_fused), w_at=4)


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
    """One GRU chain over a precomputed projection, with a carried h0:
    :func:`gru_scan_plain`, planned by :func:`persist_plan.plan_gru_scan`
    (float32: :func:`persist_plan.plan_gru_f32_forward`). Its counters also
    count :func:`gru_scan_bidi`'s bf16 persistent launches, this kernel's."""
    return walks.run(GRU_SCAN, [(gx, lengths, w_hh, b_ih, b_hh, h0)], [reverse], design)[0]


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


def _scan_bidi_step(chains, reverses):
    """T launches of the step kernel, both directions in each: the forward
    chain, then the reverse-time one. ``chains`` holds two (gx, lengths,
    w_hh, b_ih, b_hh, h0) tuples; returns one (out, h_last) per chain."""
    launch = cuda_build.bind("gru_scan_bidi", "gru_scan_bidi_launch", 12, 3)
    (gx_f, lengths, w_hh_f, b_ih_f, b_hh_f, _), (gx_b, _, w_hh_b, b_ih_b, b_hh_b, _) = chains
    t_max, batch, _ = gx_f.shape
    hidden = w_hh_f.shape[0]
    dev = gx_f.device
    h32 = torch.empty((2, 2, batch, hidden), dtype=torch.float32, device=dev)
    h16 = torch.empty((2, 2, batch, hidden), dtype=torch.bfloat16, device=dev)
    for d, c in enumerate(chains):
        h32[0, d].copy_(c[5])
        h16[0, d].copy_(c[5])  # round to nearest even, as __float2bfloat16
    out = torch.empty((2, t_max, batch, hidden), dtype=torch.bfloat16, device=dev)
    cuda_build.call(
        launch, "gru_scan_bidi (step)", dev,
        gx_f.data_ptr(), gx_b.data_ptr(), lengths.data_ptr(),
        w_hh_f.data_ptr(), w_hh_b.data_ptr(), b_ih_f.data_ptr(), b_ih_b.data_ptr(),
        b_hh_f.data_ptr(), b_hh_b.data_ptr(), h32.data_ptr(), h16.data_ptr(),
        out.data_ptr(), t_max, batch, hidden)
    last = h32[t_max % 2]  # the buffer the final step wrote
    return [(out[0], last[0]), (out[1], last[1])]


def gru_scan_bidi(
    gx_f, gx_b, lengths, w_hh_f, w_hh_b, b_ih_f, b_ih_b, b_hh_f, b_hh_b, h0_f, h0_b,
    design: str | None = None,
):
    """Both chains of a bidirectional GRU layer over precomputed
    projections, with carried initial states: :func:`gru_scan_bidi_plain`.
    The persistent design is :func:`gru_scan`'s kernel (float32:
    ``gru_f32_persist_kernel``), planned as it is, its bf16 launches counted
    on :func:`gru_scan`; the step design is ``csrc/gru_scan_bidi.cu``
    (float32: ``gru_f32_step_kernel``), both directions in each step."""
    if gx_b.shape != gx_f.shape or gx_b.device != gx_f.device:
        raise ValueError(
            f"gx_b {tuple(gx_b.shape)} on {gx_b.device} does not match gx_f "
            f"{tuple(gx_f.shape)} on {gx_f.device}"
        )
    (out_f, hl_f), (out_b, hl_b) = walks.run(
        GRU_SCAN_BIDI, [(gx_f, lengths, w_hh_f, b_ih_f, b_hh_f, h0_f),
                        (gx_b, lengths, w_hh_b, b_ih_b, b_hh_b, h0_b)], [False, True], design)
    return out_f, out_b, hl_f, hl_b


GRU_SCAN = walks.Walk(
    check=_check_scan_operands, plain=gru_scan_plain,
    plan=lambda h, b, chains, *info: persist_plan.plan_gru_scan(h, b, *info, chains=chains),
    plan_f32=persist_plan.plan_gru_f32_forward,
    persistent=_scan_persistent, step=walks.each(_scan_step),
    persistent_f32=_scan_f32_persistent, step_f32=_scan_f32,
    counter=walks.counted(gru_scan))
GRU_SCAN_BIDI = dataclasses.replace(
    GRU_SCAN, step=_scan_bidi_step, step_chains=2, counter=walks.counted(gru_scan_bidi),
    owner=gru_scan)


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
    """The backward walk of one GRU chain: :func:`gru_bwd_scan_plain`, the
    gate-recompute product and the walk in one C call, planned by
    :func:`persist_plan.plan_gru_backward` (float32:
    :func:`persist_plan.plan_gru_f32_backward`)."""
    ops = (gx, hprev, dout, lengths, w_hh, b_ih, b_hh, dh_last)
    return walks.run(GRU_BWD_SCAN, [ops], [reverse], design)[0]


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
    """The backward walks of the two chains of a bidirectional layer:
    ``chain_a`` and ``chain_b`` are operand tuples of :func:`gru_bwd_scan`
    over the same lengths tensor; returns its result for each. On the card
    both share one launch where the plan allows (each chain has its own
    barrier: the step count on the critical path halves)."""
    a, b = walks.run(GRU_BWD_SCAN, [chain_a, chain_b], [reverse_a, reverse_b], design)
    return a, b


GRU_BWD_SCAN = walks.Walk(
    check=_check_bwd_operands, plain=gru_bwd_scan_plain,
    plan=persist_plan.plan_gru_backward, plan_f32=persist_plan.plan_gru_f32_backward,
    persistent=_bwd_persistent, step=walks.each(_bwd_step),
    persistent_f32=_bwd_f32_persistent, step_f32=_bwd_f32,
    counter=walks.counted(gru_bwd_scan), lengths_at=3, w_at=4)


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
