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
H100 and what the design does about it. All three have two designs, as the GRU ones: "persistent" (one
cooperative launch walks every step, ``csrc/persist.cuh``) and "step" (one
launch per time step), chosen by :func:`persist_plan.plan_lstm_forward` /
:func:`persist_plan.plan_lstm_backward` or by ``design=``;
:func:`lstm_scan_pair` and :func:`lstm_bwd_scan_pair` run both chains of a
bidirectional layer in one persistent launch.

Each wrapper takes two sets of operands, told apart by the dtype of its
sequence: bf16 sequences and weights with f32 biases and states (the
designs above), or everything in float32, which runs the float32 variants of
``csrc/lstm_f32.cu``. Their forward walk (B5, B6) has both designs:
"persistent" is one cooperative launch of ``lstm_f32_persist_kernel``, each
block keeping what fits of its float32 slice resident and streaming the rest
from L2 (:func:`persist_plan.plan_lstm_f32_forward` plans it), "step" one
launch per time step. The float32 backward walk (B7) has both too:
"persistent" is the FFMA gate recompute, then one cooperative launch of
``lstm_f32_bwd_persist_kernel`` (:func:`persist_plan.plan_lstm_f32_backward`),
"step" the recompute and T + 1 step launches. A mixed set raises
``TypeError``.
``<wrapper>.dtype_counts`` counts the CUDA calls (or chains) by the set
taken.

A wrapper launches its kernel for CUDA tensors and raises on anything the
kernel does not take; for CPU tensors, and only for those, it runs the plain
version (dtype-generic). There is no fallback from a failed build or launch
to the plain version.
"""

from __future__ import annotations

import torch

from . import cuda_build, persist_plan
from .cuda_build import chain_ptrs
from .cuda_checks import (check_proj_rows, check_stream_shape, check_tensors, count,
                          pair_dtype, time_order)
from .gru_cuda import device_info, f32_rows, f32_slices, sgemm_f32, transposed


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


def _scan_cuda(wrapper, gx, lengths, w_hh, b_hh, h0, c0, reverse, with_cell, design):
    """One chain on the card: the float32 variant for the float32 set, else
    the design the plan (or ``design``) gives; counted on ``wrapper``."""
    if gx.device.type != "cuda":
        raise ValueError(f"unsupported device {gx.device}")
    dtype = _check_scan_operands(gx, lengths, w_hh, b_hh, h0, c0)
    chain = (gx, lengths, w_hh, b_hh, h0, c0)
    if dtype == torch.float32:
        planned = persist_plan.plan_lstm_f32_forward(w_hh.shape[0], gx.shape[1], 1,
                                                     *device_info(gx.device))
        design = persist_plan.choose(design, planned)
        if design == "persistent":
            result = _scan_f32_persistent([chain], [reverse], with_cell, planned)[0]
        else:
            result = _scan_f32([chain], [reverse], with_cell)[0]
    else:
        planned = persist_plan.plan_lstm_forward(w_hh.shape[0], gx.shape[1], 1,
                                                 *device_info(gx.device))
        design = persist_plan.choose(design, planned)
        if design == "persistent":
            result = _persistent([chain], [reverse], with_cell, planned)[0]
        else:
            result = _step(*chain, reverse, with_cell)
    count(wrapper, design, dtype)
    return result


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


def _step(gx, lengths, w_hh, b_hh, h0, c0, reverse, with_cell):
    """T launches of the step kernel."""
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
    """One LSTM chain over a precomputed projection, with carried h0, c0.

    Same contract and return values as :func:`lstm_scan_plain`. A CUDA ``gx``
    launches the kernel (bf16 gx and w_hh, f32 b_hh, h0 and c0, int32
    lengths, all contiguous on gx's device; or everything float32, the
    float32 variant) or raises; a CPU ``gx`` runs the plain version.
    ``design`` is None (the plan of :func:`persist_plan.plan_lstm_forward`
    decides, :func:`persist_plan.plan_lstm_f32_forward` for float32),
    "persistent" or "step"; ``lstm_scan.design_counts`` and
    ``lstm_scan.dtype_counts`` count the CUDA calls by the design and the
    operand set taken. ``lstm_scan.launches`` counts kernel launches (one per
    call).
    """
    if gx.device.type == "cpu":
        return lstm_scan_plain(gx, lengths, w_hh, b_hh, h0, c0, reverse)
    return _scan_cuda(lstm_scan, gx, lengths, w_hh, b_hh, h0, c0, reverse, False, design)


lstm_scan.launches = 0
lstm_scan.design_counts = {"persistent": 0, "step": 0}
lstm_scan.dtype_counts = {"bfloat16": 0, "float32": 0}


def lstm_scan_with_cell(gx, lengths, w_hh, b_hh, h0, c0, reverse: bool = False,
                        design: str | None = None):
    """One LSTM chain that also writes its cell sequence.

    Same contract and return values as :func:`lstm_scan_with_cell_plain`; a
    CUDA ``gx`` launches the kernel or raises, a CPU ``gx`` runs the plain
    version, and ``design`` and the counters are those of :func:`lstm_scan`.
    """
    if gx.device.type == "cpu":
        return lstm_scan_with_cell_plain(gx, lengths, w_hh, b_hh, h0, c0, reverse)
    return _scan_cuda(lstm_scan_with_cell, gx, lengths, w_hh, b_hh, h0, c0, reverse, True,
                      design)


lstm_scan_with_cell.launches = 0
lstm_scan_with_cell.design_counts = {"persistent": 0, "step": 0}
lstm_scan_with_cell.dtype_counts = {"bfloat16": 0, "float32": 0}


def lstm_scan_pair(chain_a, chain_b, reverse_a: bool, reverse_b: bool,
                   with_cell: bool = False, design: str | None = None):
    """Both chains of a bidirectional LSTM layer.

    ``chain_a`` and ``chain_b`` are the operand tuples (gx, lengths, w_hh,
    b_hh, h0, c0) of :func:`lstm_scan`, over the same lengths tensor and
    shapes. Returns (the results of a, the results of b), each as
    :func:`lstm_scan` (or, with ``with_cell``, :func:`lstm_scan_with_cell`)
    would return it. On CUDA both chains share one persistent launch when the
    plan for two chains fits (each chain with its own barrier, so the two
    never wait for each other), and that wrapper's ``launches`` and
    ``design_counts`` grow by one; otherwise, for ``design="step"``, and on
    the CPU, they run one after the other as two calls of that wrapper.
    Float32 chains take the plans of
    :func:`persist_plan.plan_lstm_f32_forward`: both in one cooperative
    launch where the plan for two fits, else one launch a chain where the
    plan for one does; ``design="step"`` (or no plan that fits) walks both
    in each of the T launches of the float32 step kernel. Either way the
    float32 counts grow by two: they count chains.
    """
    scan = lstm_scan_with_cell if with_cell else lstm_scan
    if chain_a[0].device.type != "cuda":
        return scan(*chain_a, reverse=reverse_a), scan(*chain_b, reverse=reverse_b)
    dtype = pair_dtype(_check_scan_operands, chain_a, chain_b)
    if chain_a[0].shape != chain_b[0].shape or chain_a[1] is not chain_b[1]:
        raise ValueError("the two chains must share their shapes and lengths")
    if dtype == torch.float32:
        outs, design = persist_plan.run_f32_pair(
            persist_plan.plan_lstm_f32_forward, chain_a[2].shape[0], chain_a[0].shape[1],
            device_info(chain_a[0].device), design, [chain_a, chain_b], [reverse_a, reverse_b],
            lambda c, r: _scan_f32(c, r, with_cell),
            lambda c, r, p: _scan_f32_persistent(c, r, with_cell, p))
        count(scan, design, dtype, 2)
        return outs[0], outs[1]
    planned = persist_plan.plan_lstm_forward(
        chain_a[2].shape[0], chain_a[0].shape[1], 2, *device_info(chain_a[0].device))
    if design == "step" or planned.design != "persistent":
        return (scan(*chain_a, reverse=reverse_a, design=design),
                scan(*chain_b, reverse=reverse_b, design=design))
    persist_plan.choose(design, planned)
    outs = _persistent([chain_a, chain_b], [reverse_a, reverse_b], with_cell, planned)
    count(scan, "persistent", dtype)
    return outs[0], outs[1]


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
    """The backward walk of one LSTM chain.

    Same contract and return values as :func:`lstm_bwd_scan_plain`. A CUDA
    ``gx`` launches the kernel (bf16 gx, hprev, cprev and w_hh, f32 dout and
    b_hh, int32 lengths, all contiguous on gx's device; or everything
    float32, the float32 variant) or raises; a CPU ``gx`` runs the plain
    version. ``design`` is None (the plan of
    :func:`persist_plan.plan_lstm_backward` decides,
    :func:`persist_plan.plan_lstm_f32_backward` for float32), "persistent" or
    "step"; ``lstm_bwd_scan.design_counts`` and ``lstm_bwd_scan.dtype_counts``
    count the chains by the design and the operand set taken.
    ``lstm_bwd_scan.launches`` counts chains (one per call: the
    gate-recompute product and the walk), ``lstm_bwd_scan.pair_launches``
    the cooperative launches that walked two chains
    (:func:`lstm_bwd_scan_pair`).
    """
    args = (gx, hprev, cprev, dout, lengths, w_hh, b_hh)
    if gx.device.type == "cpu":
        return lstm_bwd_scan_plain(*args, reverse)
    if gx.device.type != "cuda":
        raise ValueError(f"unsupported device {gx.device}")
    dtype = _check_bwd_operands(*args)
    if dtype == torch.float32:
        planned = persist_plan.plan_lstm_f32_backward(w_hh.shape[0], gx.shape[1], 1,
                                                      *device_info(gx.device))
        design = persist_plan.choose(design, planned)
        if design == "persistent":
            result = _bwd_f32_persistent([args], [reverse], planned)[0]
        else:
            result = _bwd_f32([args], [reverse])[0]
    else:
        planned = persist_plan.plan_lstm_backward(w_hh.shape[0], gx.shape[1], 1,
                                                  *device_info(gx.device))
        design = persist_plan.choose(design, planned)
        if design == "persistent":
            result = _bwd_persistent([args], [reverse], planned)[0]
        else:
            result = _bwd_step(*args, reverse)
    count(lstm_bwd_scan, design, dtype)
    return result


lstm_bwd_scan.launches = 0
lstm_bwd_scan.pair_launches = 0
lstm_bwd_scan.design_counts = {"persistent": 0, "step": 0}
lstm_bwd_scan.dtype_counts = {"bfloat16": 0, "float32": 0}


def lstm_bwd_scan_pair(chain_a, chain_b, reverse_a: bool, reverse_b: bool,
                       design: str | None = None):
    """The backward walks of the two chains of a bidirectional LSTM layer.

    ``chain_a`` and ``chain_b`` are the operand tuples (gx, hprev, cprev,
    dout, lengths, w_hh, b_hh) of :func:`lstm_bwd_scan`, of the same shapes
    and over the same lengths tensor (else ValueError, on any device).
    Returns ((dg4, dh0, dc0) of a, the same of b), each as
    :func:`lstm_bwd_scan` would return it. On CUDA both walks share one
    persistent launch when the plan for two chains fits (each chain has its
    own barrier, so the two never wait for each other) and
    ``lstm_bwd_scan.pair_launches`` grows by one; otherwise, for
    ``design="step"``, and on the CPU, they run one after the other as two
    :func:`lstm_bwd_scan` calls. Float32 chains take the plans of
    :func:`persist_plan.plan_lstm_f32_backward`: both in one cooperative
    launch where the plan for two fits, else one launch a chain where the
    plan for one does; ``design="step"`` (or no plan that fits) walks both
    in each of the T + 1 launches of the float32 step kernel;
    ``pair_launches`` counts only the cooperative bf16 launches. Either way
    ``lstm_bwd_scan.launches`` grows by two: it counts chains.
    """
    if (tuple(chain_a[0].shape) != tuple(chain_b[0].shape)
            or tuple(chain_a[5].shape) != tuple(chain_b[5].shape)
            or chain_a[4] is not chain_b[4]):
        raise ValueError("the two chains must share their shapes and lengths")
    if chain_a[0].device.type != "cuda":
        return (lstm_bwd_scan(*chain_a, reverse=reverse_a),
                lstm_bwd_scan(*chain_b, reverse=reverse_b))
    dtype = pair_dtype(_check_bwd_operands, chain_a, chain_b)
    if dtype == torch.float32:
        outs, design = persist_plan.run_f32_pair(
            persist_plan.plan_lstm_f32_backward, chain_a[5].shape[0], chain_a[0].shape[1],
            device_info(chain_a[0].device), design, [chain_a, chain_b], [reverse_a, reverse_b],
            _bwd_f32, _bwd_f32_persistent)
        count(lstm_bwd_scan, design, dtype, 2)
        return outs[0], outs[1]
    planned = persist_plan.plan_lstm_backward(
        chain_a[5].shape[0], chain_a[0].shape[1], 2, *device_info(chain_a[0].device))
    if design == "step" or planned.design != "persistent":
        return (lstm_bwd_scan(*chain_a, reverse=reverse_a, design=design),
                lstm_bwd_scan(*chain_b, reverse=reverse_b, design=design))
    persist_plan.choose(design, planned)
    outs = _bwd_persistent([chain_a, chain_b], [reverse_a, reverse_b], planned)
    count(lstm_bwd_scan, "persistent", dtype, 2)
    lstm_bwd_scan.pair_launches += 1
    return outs[0], outs[1]
