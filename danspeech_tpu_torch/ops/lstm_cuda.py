"""LSTM kernels and their plain PyTorch versions.

The ports of three kernels of ``danspeech_tpu/ops/pallas_gru.py``, gate
order i, f, g, o:

- :func:`lstm_scan` (``lstm_scan``, ``csrc/lstm_scan.cu``): one chain over a
  precomputed projection, with carried h0 and c0 and a ``reverse`` flag
  (serving, and the forward pass that needs no gradient);
- :func:`lstm_scan_with_cell` (``lstm_scan_with_cell``, the same source and
  step kernel): the chain that also writes the masked cell sequence, the
  residual of the backward walk (the training forward);
- :func:`lstm_bwd_scan` (``lstm_bwd_scan``, ``csrc/lstm_bwd.cu``): the
  backward walk of one chain; :func:`lstm_bwd_scan_pair` walks both chains
  of a bidirectional layer in one launch.

Each takes an input projection ``gx`` and one f32 bias vector, which it
adds at every step: ``ops/rnn.py`` hands the bias-free product ``x @
w_ih`` in the stream dtype and ``b_ih + b_hh`` as that vector (the operand
named ``b_hh`` here), so no pass touches the gate stream between the GEMM
and the walk (the JAX package's ``_lstm_project`` puts ``b_ih`` inside the
projection instead). Each source's header note says what bounds it on an
H100 and what the design does about it. All three have two designs, as the
GRU ones: "persistent" (one cooperative launch walks every step,
``csrc/persist.cuh``) and "step" (one launch per time step);
:func:`lstm_scan_pair` and :func:`lstm_bwd_scan_pair` run both chains of a
bidirectional layer in one persistent launch where the plan allows.

Each wrapper takes two sets of operands, told apart by the dtype of its
sequence: bf16 sequences and weights with f32 biases and states, or
everything in float32, which runs the float32 variants of
``csrc/lstm_f32.cu`` (B5, B6: ``lstm_f32_persist_kernel``, each block
keeping what fits of its float32 slice resident and streaming the rest from
L2, or one launch a step; B7: the FFMA gate recompute, then
``lstm_f32_bwd_persist_kernel`` or T + 1 step launches). A mixed set raises
``TypeError``. Every wrapper hands its chains to :func:`walks.run`, which
runs the plain version (dtype-generic) for CPU tensors and only for those,
and on the card checks the operands, plans, takes ``design=``, launches and
counts, with no fallback from a failed build or launch to the plain
version.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch

from . import cuda_build, persist_plan, walks
from .cuda_build import chain_ptrs
from .cuda_checks import check_proj_rows, check_stream_shape, check_tensors, time_order
from .gru_cuda import f32_rows, f32_slices, sgemm_f32, transposed


def _gates(pre, hidden):
    return (
        torch.sigmoid(pre[:, :hidden]),
        torch.sigmoid(pre[:, hidden : 2 * hidden]),
        torch.tanh(pre[:, 2 * hidden : 3 * hidden]),
        torch.sigmoid(pre[:, 3 * hidden :]),
    )


def _scan_plain(gx, lengths, w_hh, b_hh, h0, c0, reverse, with_cell):
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    dev = gx.device
    mm_dtype = w_hh.dtype
    w = w_hh.float()
    b_hh = b_hh.float()
    lengths = lengths.to(dev)
    h, c = h0.float(), c0.float()
    out = torch.empty((t_max, batch, hidden), dtype=gx.dtype, device=dev)
    cseq = torch.empty_like(out) if with_cell else None
    for t in time_order(t_max, reverse):
        pre = gx[t].float() + h.to(mm_dtype).float() @ w + b_hh
        i, f, g, o = _gates(pre, hidden)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        valid = (lengths > t)[:, None]
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        out[t] = torch.where(valid, h_new, torch.zeros_like(h_new)).to(gx.dtype)
        if with_cell:
            cseq[t] = torch.where(valid, c_new, torch.zeros_like(c_new)).to(gx.dtype)
    return (out, cseq, h, c) if with_cell else (out, h, c)


def lstm_scan_plain(gx, lengths, w_hh, b_hh, h0, c0, reverse: bool = False):
    """The kernel's arithmetic in plain tensor ops, on any device.

    gx (T, B, 4H) is the input projection in the stream dtype, w_hh (H, 4H)
    in the weights' dtype, b_hh (4H,) f32 the bias added at every step (the
    layers hand ``x @ w_ih`` and ``b_ih + b_hh``), h0 and c0 (B, H) f32,
    lengths (B,). Returns (out (T, B, H) in gx's dtype with exact zeros where
    t >= length, h_last, c_last (B, H) f32). ``reverse`` walks t = T-1 .. 0
    and holds the states until t < length. The product takes h rounded to
    w_hh's dtype and accumulates in f32 (both operands upcast first: a bf16
    matmul on the CPU would round its result).
    """
    return _scan_plain(gx, lengths, w_hh, b_hh, h0, c0, reverse, False)


def lstm_scan_with_cell_plain(gx, lengths, w_hh, b_hh, h0, c0, reverse: bool = False):
    """:func:`lstm_scan_plain` that also returns the cell sequence: (out,
    c_seq, h_last, c_last), c_seq (T, B, H) the new cell state of each valid
    step rounded to gx's dtype, exact zeros where t >= length."""
    return _scan_plain(gx, lengths, w_hh, b_hh, h0, c0, reverse, True)


def _check_scan_operands(gx, lengths, w_hh, b_hh, h0, c0):
    if w_hh.dim() != 2:
        raise ValueError(f"w_hh must be (H, 4H), got shape {tuple(w_hh.shape)}")
    hidden = w_hh.shape[0]
    check_stream_shape("gx", gx, 4, hidden)
    t_max, batch, _ = gx.shape
    return check_tensors("gx", {
        "gx": (gx, (t_max, batch, 4 * hidden), torch.bfloat16),
        "lengths": (lengths, (batch,), torch.int32),
        "w_hh": (w_hh, (hidden, 4 * hidden), torch.bfloat16),
        "b_hh": (b_hh, (4 * hidden,), torch.float32),
        "h0": (h0, (batch, hidden), torch.float32),
        "c0": (c0, (batch, hidden), torch.float32),
    })


def _scan_f32(chains, reverses, with_cell):
    """The float32 variant (``csrc/lstm_f32.cu``) over one or two chains that
    share T, B, H and lengths: T launches of the step kernel, each chain a
    slice of the grid, the cell streams written only ``with_cell``.
    ``chains`` holds (gx, lengths, w_hh, b_hh, h0, c0) tuples; returns one
    result tuple per chain, as :func:`lstm_scan` or
    :func:`lstm_scan_with_cell` gives it."""
    launch = cuda_build.bind("lstm_f32", "lstm_f32_scan_launch", 13, 6)
    gx, lengths, w_hh = chains[0][:3]
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    dev = gx.device
    n = len(chains)
    h32 = torch.empty((2, n, batch, hidden), dtype=torch.float32, device=dev)
    for k, c in enumerate(chains):
        h32[0, k].copy_(c[4])
    # c0 on entry, updated in place by the thread that owns each (b, j), c_last on exit
    c32 = torch.stack([c[5] for c in chains])
    outs = [torch.empty((t_max, batch, hidden), dtype=torch.float32, device=dev)
            for _ in chains]
    cseqs = [torch.empty_like(o) if with_cell else None for o in outs]
    cuda_build.call(
        launch, "lstm_scan (float32)", dev,
        *chain_ptrs([c[0] for c in chains]), lengths.data_ptr(),
        *chain_ptrs([c[2] for c in chains]), *chain_ptrs([c[3] for c in chains]),
        h32.data_ptr(), c32.data_ptr(), *chain_ptrs(outs), *chain_ptrs(cseqs),
        t_max, batch, hidden, int(bool(reverses[0])), int(bool(reverses[-1])), n)
    last = h32[t_max % 2]  # the buffer the final step wrote
    return [(o, cs, last[k], c32[k]) if with_cell else (o, last[k], c32[k])
            for k, (o, cs) in enumerate(zip(outs, cseqs))]


def _scan_f32_persistent(chains, reverses, with_cell, planned):
    """The float32 variant, persistent (``csrc/lstm_f32.cu``): one or two
    chains that share T, B, H and lengths in one cooperative launch of the
    planned grid, each chain with its own barrier, the cell streams written
    only ``with_cell``. ``chains`` holds (gx, lengths, w_hh, b_hh, h0, c0)
    tuples; returns one result tuple per chain, as :func:`lstm_scan` or
    :func:`lstm_scan_with_cell` gives it."""
    launch = cuda_build.bind("lstm_f32", "lstm_f32_persist_launch", 17, 17)
    gx, lengths, w_hh = chains[0][:3]
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    dev = gx.device
    n = len(chains)
    hx = torch.zeros((2, n, planned.padded_depth, planned.padded_rows),
                     dtype=torch.float32, device=dev)
    for k, c in enumerate(chains):
        hx[0, k, :hidden, :batch].copy_(c[4].t())  # h0 transposed: rows of units
    slices = [f32_slices(c[2], planned.units, planned.blocks_per_dir, planned.padded_depth)
              for c in chains]
    outs = []
    for c in chains:
        out = torch.empty((t_max, batch, hidden), dtype=torch.float32, device=dev)
        cseq = torch.empty_like(out) if with_cell else None
        # c0 on entry, c_last on exit
        outs.append((out, cseq, torch.empty((batch, hidden), dtype=torch.float32, device=dev),
                     c[5].clone()))
    barrier = torch.zeros((n,), dtype=torch.int32, device=dev)
    cuda_build.call(
        launch, "lstm_scan (float32, persistent)", dev,
        *chain_ptrs([c[0] for c in chains]), lengths.data_ptr(), *chain_ptrs(slices),
        *chain_ptrs([c[3] for c in chains]), hx.data_ptr(), *chain_ptrs([o[3] for o in outs]),
        *chain_ptrs([o[2] for o in outs]), *chain_ptrs([o[0] for o in outs]),
        *chain_ptrs([o[1] for o in outs]), barrier.data_ptr(),
        t_max, batch, hidden, int(bool(reverses[0])), int(bool(reverses[-1])), n,
        *planned.c_args())
    return [o if with_cell else (o[0], o[2], o[3]) for o in outs]


# launches of lstm_step_kernel, one a step walked, as a trace counts its
# events (walks.run counts a step design's run of T launches as one): the
# served path of a width whose resident slices do not fit (H = 2048)
lstm_step_launches = SimpleNamespace(design_counts={"step": 0})


def _step(gx, lengths, w_hh, b_hh, h0, c0, reverse, with_cell):
    """T launches of the step kernel, counted on :data:`lstm_step_launches`."""
    name = "lstm_scan_with_cell" if with_cell else "lstm_scan"
    launch = cuda_build.bind("lstm_scan", f"{name}_launch", 9 if with_cell else 8, 4)
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    dev = gx.device
    h32 = torch.empty((2, batch, hidden), dtype=torch.float32, device=dev)
    h16 = torch.empty((2, batch, hidden), dtype=torch.bfloat16, device=dev)
    h32[0].copy_(h0)
    h16[0].copy_(h0)  # round to nearest even, as __float2bfloat16
    c = c0.clone()  # updated in place by the thread that owns each (b, j)
    out = torch.empty((t_max, batch, hidden), dtype=torch.bfloat16, device=dev)
    cseq = torch.empty_like(out) if with_cell else None
    streams = [out.data_ptr()] + ([cseq.data_ptr()] if with_cell else [])
    cuda_build.call(launch, f"{name} (step)", dev,
                    gx.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                    h32.data_ptr(), h16.data_ptr(), c.data_ptr(), *streams,
                    t_max, batch, hidden, int(bool(reverse)))
    lstm_step_launches.design_counts["step"] += t_max
    h_last = h32[t_max % 2]  # the buffer the final step wrote
    return (out, cseq, h_last, c) if with_cell else (out, h_last, c)


def _persistent(chains, reverses, with_cell, planned):
    """One or two chains that share T, B, H and lengths in one cooperative
    launch. ``chains`` holds (gx, lengths, w_hh, b_hh, h0, c0) tuples;
    returns one result tuple per chain, as :func:`lstm_scan` or
    :func:`lstm_scan_with_cell` gives it."""
    launch = cuda_build.bind("lstm_scan", "lstm_scan_persist_launch", 17, 12)
    gx, lengths, w_hh = chains[0][:3]
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    dev = gx.device
    n = len(chains)
    h16 = torch.empty((2, n, batch, hidden), dtype=torch.bfloat16, device=dev)
    outs, w_hht = [], []
    for k, (_, _, w, _, h0, c0) in enumerate(chains):
        h16[0, k].copy_(h0)  # round to nearest even, as __float2bfloat16
        out = torch.empty((t_max, batch, hidden), dtype=torch.bfloat16, device=dev)
        cseq = torch.empty_like(out) if with_cell else None
        # h and c: the carried states on entry, updated in place, the last on exit
        outs.append((out, cseq, h0.clone(), c0.clone()))
        w_hht.append(transposed(w))  # the resident slices are rows of w_hh^T
    barrier = torch.zeros((n,), dtype=torch.int32, device=dev)

    cuda_build.call(
        launch, "lstm_scan (persistent)", dev,
        *chain_ptrs([c[0] for c in chains]), lengths.data_ptr(), *chain_ptrs(w_hht),
        *chain_ptrs([c[3] for c in chains]), *chain_ptrs([o[2] for o in outs]),
        *chain_ptrs([o[3] for o in outs]), h16.data_ptr(), *chain_ptrs([o[0] for o in outs]),
        *chain_ptrs([o[1] for o in outs]), barrier.data_ptr(),
        t_max, batch, hidden, int(bool(reverses[0])), int(bool(reverses[-1])), n,
        planned.units, planned.row_groups, planned.stages, planned.chunk_depth,
        planned.blocks_per_dir, planned.smem_bytes)
    return [o if with_cell else (o[0], o[2], o[3]) for o in outs]


def lstm_scan(gx, lengths, w_hh, b_hh, h0, c0, reverse: bool = False,
              design: str | None = None):
    """One LSTM chain over a precomputed projection, with carried h0, c0:
    :func:`lstm_scan_plain`, planned by :func:`persist_plan.plan_lstm_forward`
    (float32: :func:`persist_plan.plan_lstm_f32_forward`)."""
    return walks.run(LSTM_SCAN, [(gx, lengths, w_hh, b_hh, h0, c0)], [reverse], design)[0]


def lstm_scan_with_cell(gx, lengths, w_hh, b_hh, h0, c0, reverse: bool = False,
                        design: str | None = None):
    """One LSTM chain that also writes its cell sequence:
    :func:`lstm_scan_with_cell_plain`, planned as :func:`lstm_scan`. Its
    bf16 persistent launches are ``lstm_persist_kernel``'s, counted on
    :func:`lstm_scan`."""
    chain = (gx, lengths, w_hh, b_hh, h0, c0)
    return walks.run(LSTM_SCAN_WITH_CELL, [chain], [reverse], design)[0]


def lstm_scan_pair(chain_a, chain_b, reverse_a: bool, reverse_b: bool,
                   with_cell: bool = False, design: str | None = None):
    """Both chains of a bidirectional LSTM layer: ``chain_a`` and
    ``chain_b`` are operand tuples of :func:`lstm_scan` over the same
    lengths tensor; returns the result of :func:`lstm_scan` (with
    ``with_cell``, :func:`lstm_scan_with_cell`) for each. On the card both
    share one launch where the plan allows, each chain with its own barrier,
    so the two never wait for each other."""
    walk = LSTM_SCAN_WITH_CELL if with_cell else LSTM_SCAN
    a, b = walks.run(walk, [chain_a, chain_b], [reverse_a, reverse_b], design)
    return a, b


LSTM_SCAN = walks.Walk(
    check=_check_scan_operands, plain=lstm_scan_plain,
    plan=persist_plan.plan_lstm_forward, plan_f32=persist_plan.plan_lstm_f32_forward,
    persistent=lambda c, r, planned: _persistent(c, r, False, planned),
    step=walks.each(lambda *chain: _step(*chain, False)),
    persistent_f32=lambda c, r, planned: _scan_f32_persistent(c, r, False, planned),
    step_f32=lambda c, r: _scan_f32(c, r, False),
    counter=walks.counted(lstm_scan))
LSTM_SCAN_WITH_CELL = dataclasses.replace(
    LSTM_SCAN, plain=lstm_scan_with_cell_plain,
    persistent=lambda c, r, planned: _persistent(c, r, True, planned),
    step=walks.each(lambda *chain: _step(*chain, True)),
    persistent_f32=lambda c, r, planned: _scan_f32_persistent(c, r, True, planned),
    step_f32=lambda c, r: _scan_f32(c, r, True),
    counter=walks.counted(lstm_scan_with_cell), owner=lstm_scan)


# ---------------------------------------------------------------------------
# lstm_bwd_scan: the backward walk of one chain
# ---------------------------------------------------------------------------


def lstm_bwd_scan_plain(gx, hprev, cprev, dout, lengths, w_hh, b_hh,
                        reverse: bool = True):
    """The kernel's arithmetic in plain tensor ops, on any device.

    gx (T, B, 4H) is the input projection the forward read, hprev and cprev
    (T, B, H) the states before each step in chain order, all in the stream
    dtype and natural time order (cprev is the cell stream as
    :func:`lstm_scan_with_cell` rounded it); dout (T, B, H) f32 is dL/d out;
    w_hh (H, 4H) in the weights' dtype; b_hh (4H,) f32, the forward's
    per-step bias. dL/dh and dL/dc start at zero. ``reverse=True`` walks
    t = T-1 .. 0 (the backward of a forward chain), ``reverse=False``
    0 .. T-1 (the backward of a reverse-time chain). Returns (dg4 (T, B,
    4H) f32, the gradient of the gate pre-activations, which is that of gx
    and of gh alike; dh0, dc0 (B, H) f32). Steps past a row's length give zeros and pass dL/dh and dL/dc
    through. Both products take operands rounded to w_hh's dtype and
    accumulate in f32.
    """
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    dev = gx.device
    mm_dtype = w_hh.dtype
    w = w_hh.float()
    w_t = w.t()
    b_hh = b_hh.float()
    lengths = lengths.to(dev)
    dh = torch.zeros((batch, hidden), dtype=torch.float32, device=dev)
    dc = torch.zeros_like(dh)
    dg4 = torch.empty((t_max, batch, 4 * hidden), dtype=torch.float32, device=dev)
    for t in time_order(t_max, reverse):
        m = (lengths > t).float()[:, None]
        cp = cprev[t].float()
        pre = gx[t].float() + hprev[t].to(mm_dtype).float() @ w + b_hh
        i, f, g, o = _gates(pre, hidden)
        tanh_c = torch.tanh(f * cp + i * g)

        dhnew = m * (dh + dout[t].float())
        dc_new = dhnew * o * (1.0 - tanh_c * tanh_c) + m * dc
        dg4_t = torch.cat([
            dc_new * g * i * (1.0 - i),
            dc_new * cp * f * (1.0 - f),
            dc_new * i * (1.0 - g * g),
            dhnew * tanh_c * o * (1.0 - o),
        ], dim=-1)
        dg4[t] = dg4_t
        dh = dg4_t.to(mm_dtype).float() @ w_t + (1.0 - m) * dh
        dc = dc_new * f + (1.0 - m) * dc
    return dg4, dh, dc


def _check_bwd_operands(gx, hprev, cprev, dout, lengths, w_hh, b_hh):
    if w_hh.dim() != 2:
        raise ValueError(f"w_hh must be (H, 4H), got shape {tuple(w_hh.shape)}")
    hidden = w_hh.shape[0]
    check_stream_shape("gx", gx, 4, hidden)
    t_max, batch, _ = gx.shape
    check_proj_rows(t_max, batch)
    return check_tensors("gx", {
        "gx": (gx, (t_max, batch, 4 * hidden), torch.bfloat16),
        "hprev": (hprev, (t_max, batch, hidden), torch.bfloat16),
        "cprev": (cprev, (t_max, batch, hidden), torch.bfloat16),
        "dout": (dout, (t_max, batch, hidden), torch.float32),
        "lengths": (lengths, (batch,), torch.int32),
        "w_hh": (w_hh, (hidden, 4 * hidden), torch.bfloat16),
        "b_hh": (b_hh, (4 * hidden,), torch.float32),
    })


def _bwd_step(gx, hprev, cprev, dout, lengths, w_hh, b_hh, reverse):
    """The gate recompute and T + 1 launches of the step kernel."""
    launch = cuda_build.bind("lstm_bwd", "lstm_bwd_launch", 12, 4)
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    dev = gx.device
    part = torch.zeros((2, batch, hidden), dtype=torch.float32, device=dev)
    dg = torch.zeros((2, batch, 4 * hidden), dtype=torch.bfloat16, device=dev)
    dc = torch.zeros((batch, hidden), dtype=torch.float32, device=dev)
    dg4 = torch.empty((t_max, batch, 4 * hidden), dtype=torch.float32, device=dev)
    w_hht = transposed(w_hh)  # held until the launch: an inference tensor's copy is not kept
    cuda_build.call(
        launch, "lstm_bwd_scan (step)", dev,
        gx.data_ptr(), hprev.data_ptr(), cprev.data_ptr(), dout.data_ptr(),
        lengths.data_ptr(), w_hh.data_ptr(), w_hht.data_ptr(), b_hh.data_ptr(),
        part.data_ptr(), dg.data_ptr(), dc.data_ptr(), dg4.data_ptr(),
        t_max, batch, hidden, int(bool(reverse)))
    return dg4, part[(t_max + 1) % 2], dc


def _bwd_f32(chains, reverses):
    """The float32 variant (``csrc/lstm_f32.cu``) of one or two walks that
    share T, B, H and lengths: the FFMA gate recompute of each chain, then
    T + 1 launches of the step kernel, each chain a slice of the grid.
    ``chains`` holds the operand tuples of :func:`lstm_bwd_scan`; returns one
    (dg4, dh0, dc0) per chain."""
    launch = cuda_build.bind("lstm_f32", "lstm_f32_bwd_launch", 17, 6)
    gx, _, _, _, lengths, w_hh = chains[0][:6]
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    dev = gx.device
    n = len(chains)
    # dh and dc start at zero, are carried in place and end as dh0 and dc0
    dh = torch.zeros((n, batch, hidden), dtype=torch.float32, device=dev)
    dc = torch.zeros_like(dh)
    dg4 = [torch.empty((t_max, batch, 4 * hidden), dtype=torch.float32, device=dev)
           for _ in chains]
    cuda_build.call(
        launch, "lstm_bwd_scan (float32)", dev,
        *(p for i in range(4) for p in chain_ptrs([c[i] for c in chains])),
        lengths.data_ptr(), *chain_ptrs([c[5] for c in chains]),
        *chain_ptrs([c[6] for c in chains]), dh.data_ptr(), dc.data_ptr(), *chain_ptrs(dg4),
        t_max, batch, hidden, int(bool(reverses[0])), int(bool(reverses[-1])), n)
    sgemm_f32.launches += 1  # the entry's GEMM (csrc/sgemm.cuh)
    return [(dg4[k], dh[k], dc[k]) for k in range(n)]


def _bwd_f32_persistent(chains, reverses, planned):
    """The float32 variant, persistent (``csrc/lstm_f32.cu``): the FFMA gate
    recompute of each chain, then one or two walks that share T, B, H and
    lengths in one cooperative launch of the planned grid, each chain with
    its own barrier. ``chains`` holds the operand tuples of
    :func:`lstm_bwd_scan`; returns one (dg4, dh0, dc0) per chain."""
    launch = cuda_build.bind("lstm_f32", "lstm_f32_bwd_persist_launch", 23, 17)
    gx, _, _, _, lengths, w_hh = chains[0][:6]
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    dev = gx.device
    n = len(chains)
    # dg4 of each step, exchanged transposed (depths of 4H, then rows); zeros
    # past 4H and past B are never written
    dg = torch.zeros((2, n, planned.padded_depth, planned.padded_rows), dtype=torch.float32,
                     device=dev)
    rows = [f32_rows(c[5], planned.units, planned.blocks_per_dir, planned.padded_depth)
            for c in chains]
    # dg4 gets the recomputed gh first; dh and dc start at zero and end as
    # dh0 and dc0
    outs = [(torch.empty((t_max, batch, 4 * hidden), dtype=torch.float32, device=dev),
             torch.zeros((batch, hidden), dtype=torch.float32, device=dev),
             torch.zeros((batch, hidden), dtype=torch.float32, device=dev)) for _ in chains]
    barrier = torch.zeros((n,), dtype=torch.int32, device=dev)
    cuda_build.call(
        launch, "lstm_bwd_scan (float32, persistent)", dev,
        *(p for i in range(4) for p in chain_ptrs([c[i] for c in chains])),
        lengths.data_ptr(), *chain_ptrs([c[5] for c in chains]), *chain_ptrs(rows),
        *chain_ptrs([c[6] for c in chains]), dg.data_ptr(), *chain_ptrs([o[1] for o in outs]),
        *chain_ptrs([o[2] for o in outs]), *chain_ptrs([o[0] for o in outs]),
        barrier.data_ptr(), t_max, batch, hidden, int(bool(reverses[0])),
        int(bool(reverses[-1])), n, *planned.c_args())
    sgemm_f32.launches += 1  # the entry's GEMM (csrc/sgemm.cuh)
    return outs


def _bwd_persistent(chains, reverses, planned):
    """The persistent walk of one or two chains that share T, B, H and
    lengths, in one launch. ``chains`` holds the operand tuples of
    :func:`lstm_bwd_scan`; returns one (dg4, dh0, dc0) per chain."""
    launch = cuda_build.bind("lstm_bwd", "lstm_bwd_persist_launch", 23, 12)
    gx, _, _, _, lengths, w_hh = chains[0][:6]
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    dev = gx.device
    n = len(chains)
    outs = []
    for _ in chains:
        # dg4 gets the recomputed gh first; dh and dc start at zero, are
        # carried in place and end as dh0 and dc0
        outs.append((torch.empty((t_max, batch, 4 * hidden), dtype=torch.float32, device=dev),
                     torch.zeros((batch, hidden), dtype=torch.float32, device=dev),
                     torch.zeros((batch, hidden), dtype=torch.float32, device=dev)))
    dg = torch.empty((2, n, batch, 4 * hidden), dtype=torch.bfloat16, device=dev)
    barrier = torch.zeros((n,), dtype=torch.int32, device=dev)
    # the gate recompute reads w_hh^T (4H, H) through the copy engine
    w_hht = [transposed(c[5]) for c in chains]

    cuda_build.call(
        launch, "lstm_bwd_scan (persistent)", dev,
        *(p for i in range(4) for p in chain_ptrs([c[i] for c in chains])),
        lengths.data_ptr(), *chain_ptrs([c[5] for c in chains]), *chain_ptrs(w_hht),
        *chain_ptrs([c[6] for c in chains]), *chain_ptrs([o[1] for o in outs]),
        *chain_ptrs([o[2] for o in outs]), dg.data_ptr(), *chain_ptrs([o[0] for o in outs]),
        barrier.data_ptr(), t_max, batch, hidden, int(bool(reverses[0])),
        int(bool(reverses[-1])), n, planned.units, planned.row_groups, planned.stages,
        planned.chunk_depth, planned.blocks_per_dir, planned.smem_bytes)
    return outs


def lstm_bwd_scan(gx, hprev, cprev, dout, lengths, w_hh, b_hh, reverse: bool = True,
                  design: str | None = None):
    """The backward walk of one LSTM chain: :func:`lstm_bwd_scan_plain`,
    the gate-recompute product and the walk in one C call, planned by
    :func:`persist_plan.plan_lstm_backward` (float32:
    :func:`persist_plan.plan_lstm_f32_backward`)."""
    ops = (gx, hprev, cprev, dout, lengths, w_hh, b_hh)
    return walks.run(LSTM_BWD_SCAN, [ops], [reverse], design)[0]


def lstm_bwd_scan_pair(chain_a, chain_b, reverse_a: bool, reverse_b: bool,
                       design: str | None = None):
    """The backward walks of the two chains of a bidirectional LSTM layer:
    ``chain_a`` and ``chain_b`` are operand tuples of :func:`lstm_bwd_scan`
    over the same lengths tensor; returns its result for each. On the card
    both share one launch where the plan allows."""
    a, b = walks.run(LSTM_BWD_SCAN, [chain_a, chain_b], [reverse_a, reverse_b], design)
    return a, b


LSTM_BWD_SCAN = walks.Walk(
    check=_check_bwd_operands, plain=lstm_bwd_scan_plain,
    plan=persist_plan.plan_lstm_backward, plan_f32=persist_plan.plan_lstm_f32_backward,
    persistent=_bwd_persistent, step=walks.each(_bwd_step),
    persistent_f32=_bwd_f32_persistent, step_f32=_bwd_f32,
    counter=walks.counted(lstm_bwd_scan), lengths_at=4, w_at=5)
