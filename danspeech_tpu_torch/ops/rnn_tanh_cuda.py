"""tanh-RNN kernels and their plain PyTorch versions.

The ports of two kernels of ``danspeech_tpu/ops/pallas_gru.py``:

- :func:`rnn_tanh_scan` (``rnn_tanh_scan``, ``csrc/rnn_tanh_scan.cu``): one
  chain ``h' = tanh(gx + h @ w_hh)`` from h = 0, with a ``reverse`` flag
  (serving and the training forward); :func:`rnn_tanh_scan_pair` runs both
  chains of a bidirectional layer in one launch;
- :func:`rnn_tanh_bwd_scan` (``rnn_tanh_bwd_scan``,
  ``csrc/rnn_tanh_bwd.cu``): the backward walk of one chain, which reads
  tanh' off the stored output stream; :func:`rnn_tanh_bwd_scan_pair` walks
  both chains of a bidirectional layer in one launch.

These take a projection ``gx`` that already holds ``b_ih + b_hh`` (added in
f32, then rounded to the stream dtype, as the JAX package's
``_rnn_project``); the kernels have no bias. Each source's header note says
what bounds it on an H100 and what the design does about it. Both kernels
have two designs, as the GRU and LSTM ones: "persistent" (one cooperative
launch walks every step, ``csrc/persist.cuh``) and "step" (one launch per
time step), chosen by :func:`persist_plan.plan_rnn_tanh_forward` /
:func:`persist_plan.plan_rnn_tanh_backward` or by ``design=``.

Each wrapper takes two sets of operands, told apart by the dtype of its
sequence: bf16 sequences and weights (the designs above), or everything in
float32, which runs the float32 variants of ``csrc/rnn_tanh_f32.cu``. Both
walks have both designs: "persistent" is one cooperative launch of
``rnn_tanh_f32_persist_kernel`` (B8) or ``rnn_tanh_f32_bwd_persist_kernel``
(B9), each block keeping its float32 slice of w_hh (B8: columns; B9: rows,
as w_hh lies) in shared memory (:func:`persist_plan.plan_rnn_tanh_f32_forward`
and :func:`persist_plan.plan_rnn_tanh_f32_backward` plan them), "step" one
launch per time step (a pair walks both chains in each step launch). A mixed
set raises ``TypeError``.
``<wrapper>.dtype_counts`` counts the chains by the set taken.

A wrapper launches its kernel for CUDA tensors and raises on anything the
kernel does not take; for CPU tensors, and only for those, it runs the plain
version (dtype-generic). There is no fallback from a failed build or launch
to the plain version.
"""

from __future__ import annotations

import torch

from . import cuda_build, persist_plan
from .cuda_build import chain_ptrs
from .cuda_checks import check_stream_shape, check_tensors, count, pair_dtype, time_order
from .gru_cuda import device_info, f32_rows, f32_slices, transposed


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
    return check_tensors(seq_name, {
        seq_name: (seq, (t_max, batch, hidden), torch.bfloat16),
        "lengths": (lengths, (batch,), torch.int32),
        "w_hh": (w_hh, (hidden, hidden), torch.bfloat16),
    })


def _scan_step(gx, lengths, w_hh, reverse):
    """T launches of the step kernel."""
    launch = cuda_build.bind("rnn_tanh_scan", "rnn_tanh_scan_launch", 6, 4)
    t_max, batch, hidden = gx.shape
    dev = gx.device
    h32 = torch.empty((2, batch, hidden), dtype=torch.float32, device=dev)
    h16 = torch.empty((2, batch, hidden), dtype=torch.bfloat16, device=dev)
    h32[0].zero_()
    h16[0].zero_()
    out = torch.empty((t_max, batch, hidden), dtype=torch.bfloat16, device=dev)
    cuda_build.call(launch, "rnn_tanh_scan (step)", dev,
                    gx.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(),
                    h32.data_ptr(), h16.data_ptr(), out.data_ptr(),
                    t_max, batch, hidden, int(bool(reverse)))
    return out, h32[t_max % 2]  # the buffer the final step wrote


def _scan_f32(chains, reverses):
    """The float32 variant (``csrc/rnn_tanh_f32.cu``) over one or two chains
    that share T, B, H and lengths: T launches of the step kernel, each chain
    a slice of the grid, from h = 0. ``chains`` holds (gx, lengths, w_hh)
    tuples; returns one (out, h_last) per chain."""
    launch = cuda_build.bind("rnn_tanh_f32", "rnn_tanh_f32_scan_launch", 8, 6)
    gx, lengths, _ = chains[0]
    t_max, batch, hidden = gx.shape
    dev = gx.device
    n = len(chains)
    h32 = torch.zeros((2, n, batch, hidden), dtype=torch.float32, device=dev)
    outs = [torch.empty((t_max, batch, hidden), dtype=torch.float32, device=dev)
            for _ in chains]
    cuda_build.call(
        launch, "rnn_tanh_scan (float32)", dev,
        *chain_ptrs([c[0] for c in chains]), lengths.data_ptr(),
        *chain_ptrs([c[2] for c in chains]), h32.data_ptr(), *chain_ptrs(outs),
        t_max, batch, hidden, int(bool(reverses[0])), int(bool(reverses[-1])), n)
    last = h32[t_max % 2]  # the buffer the final step wrote
    return [(o, last[k]) for k, o in enumerate(outs)]


def _scan_f32_persistent(chains, reverses, planned):
    """The float32 variant, persistent (``csrc/rnn_tanh_f32.cu``): one or two
    chains that share T, B, H and lengths in one cooperative launch of the
    planned grid, each chain with its own barrier, from h = 0. ``chains``
    holds (gx, lengths, w_hh) tuples; returns one (out, h_last) per chain."""
    launch = cuda_build.bind("rnn_tanh_f32", "rnn_tanh_f32_persist_launch", 11, 17)
    gx, lengths, _ = chains[0]
    t_max, batch, hidden = gx.shape
    dev = gx.device
    n = len(chains)
    # h exchanged transposed (depths, then rows); buffer 0 holds h0 = 0, and
    # the depths past H stay zero
    hx = torch.zeros((2, n, planned.padded_depth, planned.padded_rows), dtype=torch.float32,
                     device=dev)
    slices = [f32_slices(c[2], planned.units, planned.blocks_per_dir, planned.padded_depth)
              for c in chains]
    outs = [(torch.empty((t_max, batch, hidden), dtype=torch.float32, device=dev),
             torch.empty((batch, hidden), dtype=torch.float32, device=dev)) for _ in chains]
    barrier = torch.zeros((n,), dtype=torch.int32, device=dev)
    cuda_build.call(
        launch, "rnn_tanh_scan (float32, persistent)", dev,
        *chain_ptrs([c[0] for c in chains]), lengths.data_ptr(), *chain_ptrs(slices),
        hx.data_ptr(), *chain_ptrs([o[1] for o in outs]), *chain_ptrs([o[0] for o in outs]),
        barrier.data_ptr(), t_max, batch, hidden, int(bool(reverses[0])),
        int(bool(reverses[-1])), n, *planned.c_args())
    return outs


def _scan_persistent(chains, reverses, planned):
    """One or two chains that share T, B, H and lengths in one cooperative
    launch. ``chains`` holds (gx, lengths, w_hh) tuples; returns one (out,
    h_last) per chain."""
    launch = cuda_build.bind("rnn_tanh_scan", "rnn_tanh_scan_persist_launch", 11, 12)
    gx, lengths, w_hh = chains[0]
    t_max, batch, hidden = gx.shape
    dev = gx.device
    n = len(chains)
    # buffer 0 holds bf16(h0) = 0; h is carried in place and ends as h_last
    h16 = torch.zeros((2, n, batch, hidden), dtype=torch.bfloat16, device=dev)
    outs = [(torch.empty((t_max, batch, hidden), dtype=torch.bfloat16, device=dev),
             torch.zeros((batch, hidden), dtype=torch.float32, device=dev)) for _ in chains]
    barrier = torch.zeros((n,), dtype=torch.int32, device=dev)
    w_hht = [transposed(c[2]) for c in chains]  # the resident slices are rows of w_hh^T
    cuda_build.call(
        launch, "rnn_tanh_scan (persistent)", dev,
        *chain_ptrs([c[0] for c in chains]), lengths.data_ptr(), *chain_ptrs(w_hht),
        *chain_ptrs([o[1] for o in outs]), h16.data_ptr(),
        *chain_ptrs([o[0] for o in outs]), barrier.data_ptr(),
        t_max, batch, hidden, int(bool(reverses[0])), int(bool(reverses[-1])), n,
        planned.units, planned.row_groups, planned.stages, planned.chunk_depth,
        planned.blocks_per_dir, planned.smem_bytes)
    return outs


def rnn_tanh_scan(gx, lengths, w_hh, reverse: bool = False, design: str | None = None):
    """One tanh-RNN chain over a precomputed projection, from h = 0.

    Same contract and return values as :func:`rnn_tanh_scan_plain`. A CUDA
    ``gx`` launches the kernel (bf16 gx and w_hh, int32 lengths, all
    contiguous on gx's device; or float32 gx and w_hh, the float32 variant)
    or raises; a CPU ``gx`` runs the plain version. ``design`` is None (the
    plan of :func:`persist_plan.plan_rnn_tanh_forward` decides,
    :func:`persist_plan.plan_rnn_tanh_f32_forward` for float32),
    "persistent" or "step"; ``rnn_tanh_scan.design_counts`` and
    ``rnn_tanh_scan.dtype_counts`` count the chains by the design and the
    operand set taken. ``rnn_tanh_scan.launches`` counts chains (one per
    call), ``rnn_tanh_scan.pair_launches`` the cooperative launches that
    walked two chains (:func:`rnn_tanh_scan_pair`).
    """
    if gx.device.type == "cpu":
        return rnn_tanh_scan_plain(gx, lengths, w_hh, reverse)
    if gx.device.type != "cuda":
        raise ValueError(f"unsupported device {gx.device}")
    dtype = _check_operands("gx", gx, lengths, w_hh)
    if dtype == torch.float32:
        planned = persist_plan.plan_rnn_tanh_f32_forward(w_hh.shape[0], gx.shape[1], 1,
                                                         *device_info(gx.device))
        design = persist_plan.choose(design, planned)
        if design == "persistent":
            result = _scan_f32_persistent([(gx, lengths, w_hh)], [reverse], planned)[0]
        else:
            result = _scan_f32([(gx, lengths, w_hh)], [reverse])[0]
    else:
        planned = persist_plan.plan_rnn_tanh_forward(w_hh.shape[0], gx.shape[1], 1,
                                                     *device_info(gx.device))
        design = persist_plan.choose(design, planned)
        if design == "persistent":
            result = _scan_persistent([(gx, lengths, w_hh)], [reverse], planned)[0]
        else:
            result = _scan_step(gx, lengths, w_hh, reverse)
    count(rnn_tanh_scan, design, dtype)
    return result


rnn_tanh_scan.launches = 0
rnn_tanh_scan.pair_launches = 0
rnn_tanh_scan.design_counts = {"persistent": 0, "step": 0}
rnn_tanh_scan.dtype_counts = {"bfloat16": 0, "float32": 0}


def _check_pair(chain_a, chain_b):
    """The two chains of a pair must share their shapes and lengths tensor
    (in the operand tuples of both wrappers lengths comes second to last and
    w_hh last)."""
    if (tuple(chain_a[0].shape) != tuple(chain_b[0].shape)
            or tuple(chain_a[-1].shape) != tuple(chain_b[-1].shape)
            or chain_a[-2] is not chain_b[-2]):
        raise ValueError("the two chains must share their shapes and lengths")


def rnn_tanh_scan_pair(chain_a, chain_b, reverse_a: bool, reverse_b: bool,
                       design: str | None = None):
    """Both chains of a bidirectional tanh-RNN layer.

    ``chain_a`` and ``chain_b`` are the operand tuples (gx, lengths, w_hh) of
    :func:`rnn_tanh_scan`, of the same shapes and over the same lengths
    tensor (else ValueError, on any device). Returns ((out, h_last) of a,
    the same of b), each as :func:`rnn_tanh_scan` would return it. On CUDA
    both chains share one persistent launch when the plan for two chains
    fits (each chain with its own barrier, so the two never wait for each
    other) and ``rnn_tanh_scan.pair_launches`` grows by one; otherwise, for
    ``design="step"``, and on the CPU, they run one after the other as two
    :func:`rnn_tanh_scan` calls. Float32 chains take the plans of
    :func:`persist_plan.plan_rnn_tanh_f32_forward`: both in one cooperative
    launch where the plan for two fits, else one launch a chain where the
    plan for one does; ``design="step"`` (or no plan that fits) walks both
    in each of the T launches of the float32 step kernel; ``pair_launches``
    counts only the cooperative bf16 launches. Either way
    ``rnn_tanh_scan.launches`` grows by two: it counts chains.
    """
    _check_pair(chain_a, chain_b)
    if chain_a[0].device.type != "cuda":
        return (rnn_tanh_scan(*chain_a, reverse=reverse_a),
                rnn_tanh_scan(*chain_b, reverse=reverse_b))
    dtype = pair_dtype(lambda *c: _check_operands("gx", *c), chain_a, chain_b)
    if dtype == torch.float32:
        outs, design = persist_plan.run_f32_pair(
            persist_plan.plan_rnn_tanh_f32_forward, chain_a[2].shape[0], chain_a[0].shape[1],
            device_info(chain_a[0].device), design, [chain_a, chain_b], [reverse_a, reverse_b],
            _scan_f32, _scan_f32_persistent)
        count(rnn_tanh_scan, design, dtype, 2)
        return outs[0], outs[1]
    planned = persist_plan.plan_rnn_tanh_forward(
        chain_a[2].shape[0], chain_a[0].shape[1], 2, *device_info(chain_a[0].device))
    if design == "step" or planned.design != "persistent":
        return (rnn_tanh_scan(*chain_a, reverse=reverse_a, design=design),
                rnn_tanh_scan(*chain_b, reverse=reverse_b, design=design))
    persist_plan.choose(design, planned)
    outs = _scan_persistent([chain_a, chain_b], [reverse_a, reverse_b], planned)
    count(rnn_tanh_scan, "persistent", dtype, 2)
    rnn_tanh_scan.pair_launches += 1
    return outs[0], outs[1]


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


def _check_bwd_operands(out, dout, lengths, w_hh):
    _check_operands("out", out, lengths, w_hh)
    return check_tensors("out", {
        "out": (out, tuple(out.shape), torch.bfloat16),
        "dout": (dout, tuple(out.shape), torch.float32),
    })


def _bwd_step(out, dout, lengths, w_hh, reverse):
    """T + 1 launches of the step kernel."""
    launch = cuda_build.bind("rnn_tanh_bwd", "rnn_tanh_bwd_launch", 7, 4)
    t_max, batch, hidden = out.shape
    dev = out.device
    part = torch.zeros((2, batch, hidden), dtype=torch.float32, device=dev)
    dp = torch.zeros((2, batch, hidden), dtype=torch.bfloat16, device=dev)
    dpre = torch.empty((t_max, batch, hidden), dtype=torch.float32, device=dev)
    w_hht = transposed(w_hh)  # the step product reads w_hh^T
    cuda_build.call(launch, "rnn_tanh_bwd_scan (step)", dev,
                    out.data_ptr(), dout.data_ptr(), lengths.data_ptr(),
                    w_hht.data_ptr(), part.data_ptr(), dp.data_ptr(),
                    dpre.data_ptr(), t_max, batch, hidden, int(bool(reverse)))
    return dpre, part[(t_max + 1) % 2]


def _bwd_f32(chains, reverses):
    """The float32 variant (``csrc/rnn_tanh_f32.cu``) of one or two walks
    that share T, B, H and lengths: T + 1 launches of the step kernel, each
    chain a slice of the grid. ``chains`` holds the operand tuples (out,
    dout, lengths, w_hh) of :func:`rnn_tanh_bwd_scan`; returns one (dpre,
    dh0) per chain."""
    launch = cuda_build.bind("rnn_tanh_f32", "rnn_tanh_f32_bwd_launch", 10, 6)
    out, _, lengths, _ = chains[0]
    t_max, batch, hidden = out.shape
    dev = out.device
    n = len(chains)
    # dh starts at zero, is carried in place and ends as dh0
    dh = torch.zeros((n, batch, hidden), dtype=torch.float32, device=dev)
    dpre = [torch.empty((t_max, batch, hidden), dtype=torch.float32, device=dev)
            for _ in chains]
    cuda_build.call(
        launch, "rnn_tanh_bwd_scan (float32)", dev,
        *chain_ptrs([c[0] for c in chains]), *chain_ptrs([c[1] for c in chains]),
        lengths.data_ptr(), *chain_ptrs([c[3] for c in chains]), dh.data_ptr(),
        *chain_ptrs(dpre), t_max, batch, hidden, int(bool(reverses[0])),
        int(bool(reverses[-1])), n)
    return [(dpre[k], dh[k]) for k in range(n)]


def _bwd_f32_persistent(chains, reverses, planned):
    """The float32 variant, persistent (``csrc/rnn_tanh_f32.cu``): one or
    two walks that share T, B, H and lengths in one cooperative launch of the
    planned grid, each chain with its own barrier, the carry from zero.
    ``chains`` holds the operand tuples (out, dout, lengths, w_hh) of
    :func:`rnn_tanh_bwd_scan`; returns one (dpre, dh0) per chain."""
    launch = cuda_build.bind("rnn_tanh_f32", "rnn_tanh_f32_bwd_persist_launch", 13, 17)
    out, _, lengths, _ = chains[0]
    t_max, batch, hidden = out.shape
    dev = out.device
    n = len(chains)
    # dpre of each step, exchanged transposed (depths, then rows); zeros past
    # H and past B are never written
    dx = torch.zeros((2, n, planned.padded_depth, planned.padded_rows), dtype=torch.float32,
                     device=dev)
    rows = [f32_rows(c[3], planned.units, planned.blocks_per_dir, planned.padded_depth)
            for c in chains]
    outs = [(torch.empty((t_max, batch, hidden), dtype=torch.float32, device=dev),
             torch.empty((batch, hidden), dtype=torch.float32, device=dev)) for _ in chains]
    barrier = torch.zeros((n,), dtype=torch.int32, device=dev)
    cuda_build.call(
        launch, "rnn_tanh_bwd_scan (float32, persistent)", dev,
        *chain_ptrs([c[0] for c in chains]), *chain_ptrs([c[1] for c in chains]),
        lengths.data_ptr(), *chain_ptrs(rows), dx.data_ptr(),
        *chain_ptrs([o[1] for o in outs]), *chain_ptrs([o[0] for o in outs]),
        barrier.data_ptr(), t_max, batch, hidden, int(bool(reverses[0])),
        int(bool(reverses[-1])), n, *planned.c_args())
    return outs


def _bwd_persistent(chains, reverses, planned):
    """The persistent walk of one or two chains that share T, B, H and
    lengths, in one launch. ``chains`` holds the operand tuples (out, dout,
    lengths, w_hh) of :func:`rnn_tanh_bwd_scan`; returns one (dpre, dh0) per
    chain. The resident slices are rows of w_hh as it lies: no transpose."""
    launch = cuda_build.bind("rnn_tanh_bwd", "rnn_tanh_bwd_persist_launch", 13, 12)
    out, _, lengths, _ = chains[0]
    t_max, batch, hidden = out.shape
    dev = out.device
    n = len(chains)
    # dh starts at zero, is carried in place and ends as dh0
    outs = [(torch.empty((t_max, batch, hidden), dtype=torch.float32, device=dev),
             torch.zeros((batch, hidden), dtype=torch.float32, device=dev)) for _ in chains]
    dp = torch.empty((2, n, batch, hidden), dtype=torch.bfloat16, device=dev)
    barrier = torch.zeros((n,), dtype=torch.int32, device=dev)
    cuda_build.call(
        launch, "rnn_tanh_bwd_scan (persistent)", dev,
        *chain_ptrs([c[0] for c in chains]), *chain_ptrs([c[1] for c in chains]),
        lengths.data_ptr(), *chain_ptrs([c[3] for c in chains]),
        *chain_ptrs([o[1] for o in outs]), dp.data_ptr(),
        *chain_ptrs([o[0] for o in outs]), barrier.data_ptr(),
        t_max, batch, hidden, int(bool(reverses[0])), int(bool(reverses[-1])), n,
        planned.units, planned.row_groups, planned.stages, planned.chunk_depth,
        planned.blocks_per_dir, planned.smem_bytes)
    return outs


def rnn_tanh_bwd_scan(out, dout, lengths, w_hh, reverse: bool = True,
                      design: str | None = None):
    """The backward walk of one tanh-RNN chain.

    Same contract and return values as :func:`rnn_tanh_bwd_scan_plain`. A
    CUDA ``out`` launches the kernel (bf16 out and w_hh, f32 dout, int32
    lengths, all contiguous on out's device; or everything float32, the
    float32 variant) or raises; a CPU ``out`` runs the plain version.
    ``design`` is None (the plan of
    :func:`persist_plan.plan_rnn_tanh_backward` decides,
    :func:`persist_plan.plan_rnn_tanh_f32_backward` for float32),
    "persistent" or "step"; ``rnn_tanh_bwd_scan.design_counts`` and
    ``rnn_tanh_bwd_scan.dtype_counts`` count the chains by the design and the
    operand set taken. ``rnn_tanh_bwd_scan.launches`` counts chains (one per
    call), ``rnn_tanh_bwd_scan.pair_launches`` the cooperative launches that
    walked two chains (:func:`rnn_tanh_bwd_scan_pair`).
    """
    if out.device.type == "cpu":
        return rnn_tanh_bwd_scan_plain(out, dout, lengths, w_hh, reverse)
    if out.device.type != "cuda":
        raise ValueError(f"unsupported device {out.device}")
    dtype = _check_bwd_operands(out, dout, lengths, w_hh)
    chain = (out, dout, lengths, w_hh)
    if dtype == torch.float32:
        planned = persist_plan.plan_rnn_tanh_f32_backward(w_hh.shape[0], out.shape[1], 1,
                                                          *device_info(out.device))
        design = persist_plan.choose(design, planned)
        if design == "persistent":
            result = _bwd_f32_persistent([chain], [reverse], planned)[0]
        else:
            result = _bwd_f32([chain], [reverse])[0]
    else:
        planned = persist_plan.plan_rnn_tanh_backward(w_hh.shape[0], out.shape[1], 1,
                                                      *device_info(out.device))
        design = persist_plan.choose(design, planned)
        if design == "persistent":
            result = _bwd_persistent([chain], [reverse], planned)[0]
        else:
            result = _bwd_step(out, dout, lengths, w_hh, reverse)
    count(rnn_tanh_bwd_scan, design, dtype)
    return result


rnn_tanh_bwd_scan.launches = 0
rnn_tanh_bwd_scan.pair_launches = 0
rnn_tanh_bwd_scan.design_counts = {"persistent": 0, "step": 0}
rnn_tanh_bwd_scan.dtype_counts = {"bfloat16": 0, "float32": 0}


def rnn_tanh_bwd_scan_pair(chain_a, chain_b, reverse_a: bool, reverse_b: bool,
                           design: str | None = None):
    """The backward walks of the two chains of a bidirectional tanh-RNN
    layer.

    ``chain_a`` and ``chain_b`` are the operand tuples (out, dout, lengths,
    w_hh) of :func:`rnn_tanh_bwd_scan`, of the same shapes and over the same
    lengths tensor (else ValueError, on any device). Returns ((dpre, dh0) of
    a, the same of b), each as :func:`rnn_tanh_bwd_scan` would return it. On
    CUDA both walks share one persistent launch when the plan for two chains
    fits and ``rnn_tanh_bwd_scan.pair_launches`` grows by one; otherwise, for
    ``design="step"``, and on the CPU, they run one after the other as two
    :func:`rnn_tanh_bwd_scan` calls. Float32 chains take the plans of
    :func:`persist_plan.plan_rnn_tanh_f32_backward`: both in one cooperative
    launch where the plan for two fits, else one launch a chain where the
    plan for one does; ``design="step"`` (or no plan that fits) walks both
    in each of the T + 1 launches of the float32 step kernel;
    ``pair_launches`` counts only the cooperative bf16 launches. Either way
    ``rnn_tanh_bwd_scan.launches`` grows by two: it counts chains.
    """
    _check_pair(chain_a, chain_b)
    if chain_a[0].device.type != "cuda":
        return (rnn_tanh_bwd_scan(*chain_a, reverse=reverse_a),
                rnn_tanh_bwd_scan(*chain_b, reverse=reverse_b))
    dtype = pair_dtype(_check_bwd_operands, chain_a, chain_b)
    if dtype == torch.float32:
        outs, design = persist_plan.run_f32_pair(
            persist_plan.plan_rnn_tanh_f32_backward, chain_a[3].shape[0], chain_a[0].shape[1],
            device_info(chain_a[0].device), design, [chain_a, chain_b], [reverse_a, reverse_b],
            _bwd_f32, _bwd_f32_persistent)
        count(rnn_tanh_bwd_scan, design, dtype, 2)
        return outs[0], outs[1]
    planned = persist_plan.plan_rnn_tanh_backward(
        chain_a[3].shape[0], chain_a[0].shape[1], 2, *device_info(chain_a[0].device))
    if design == "step" or planned.design != "persistent":
        return (rnn_tanh_bwd_scan(*chain_a, reverse=reverse_a, design=design),
                rnn_tanh_bwd_scan(*chain_b, reverse=reverse_b, design=design))
    persist_plan.choose(design, planned)
    outs = _bwd_persistent([chain_a, chain_b], [reverse_a, reverse_b], planned)
    count(rnn_tanh_bwd_scan, "persistent", dtype, 2)
    rnn_tanh_bwd_scan.pair_launches += 1
    return outs[0], outs[1]
