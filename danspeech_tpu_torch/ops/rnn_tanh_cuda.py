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
time step).

Each wrapper takes two sets of operands, told apart by the dtype of its
sequence: bf16 sequences and weights, or everything in float32, which runs
the float32 variants of ``csrc/rnn_tanh_f32.cu``: "persistent" is one
cooperative launch of ``rnn_tanh_f32_persist_kernel`` (B8) or
``rnn_tanh_f32_bwd_persist_kernel`` (B9), each block keeping its float32
slice of w_hh (B8: columns; B9: rows, as w_hh lies) in shared memory, "step"
one launch per time step (a pair walks both chains in each step launch). A
mixed set raises ``TypeError``. Every wrapper hands its chains to
:func:`walks.run`, which runs the plain version (dtype-generic) for CPU
tensors and only for those, and on the card checks the operands, plans,
takes ``design=``, launches and counts, with no fallback from a failed
build or launch to the plain version.
"""

from __future__ import annotations

import torch

from . import cuda_build, persist_plan, walks
from .cuda_build import chain_ptrs
from .cuda_checks import check_stream_shape, check_tensors, time_order
from .gru_cuda import f32_rows, f32_slices, transposed


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
    """One tanh-RNN chain over a precomputed projection, from h = 0:
    :func:`rnn_tanh_scan_plain`, planned by
    :func:`persist_plan.plan_rnn_tanh_forward` (float32:
    :func:`persist_plan.plan_rnn_tanh_f32_forward`)."""
    return walks.run(RNN_TANH_SCAN, [(gx, lengths, w_hh)], [reverse], design)[0]


def rnn_tanh_scan_pair(chain_a, chain_b, reverse_a: bool, reverse_b: bool,
                       design: str | None = None):
    """Both chains of a bidirectional tanh-RNN layer: ``chain_a`` and
    ``chain_b`` are operand tuples of :func:`rnn_tanh_scan` over the same
    lengths tensor; returns its result for each. On the card both share one
    launch where the plan allows, each chain with its own barrier."""
    a, b = walks.run(RNN_TANH_SCAN, [chain_a, chain_b], [reverse_a, reverse_b], design)
    return a, b


RNN_TANH_SCAN = walks.Walk(
    check=lambda *chain: _check_operands("gx", *chain), plain=rnn_tanh_scan_plain,
    plan=persist_plan.plan_rnn_tanh_forward, plan_f32=persist_plan.plan_rnn_tanh_f32_forward,
    persistent=_scan_persistent, step=walks.each(_scan_step),
    persistent_f32=_scan_f32_persistent, step_f32=_scan_f32,
    counter=walks.counted(rnn_tanh_scan))


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
    """The backward walk of one tanh-RNN chain:
    :func:`rnn_tanh_bwd_scan_plain`, planned by
    :func:`persist_plan.plan_rnn_tanh_backward` (float32:
    :func:`persist_plan.plan_rnn_tanh_f32_backward`)."""
    return walks.run(RNN_TANH_BWD_SCAN, [(out, dout, lengths, w_hh)], [reverse], design)[0]


def rnn_tanh_bwd_scan_pair(chain_a, chain_b, reverse_a: bool, reverse_b: bool,
                           design: str | None = None):
    """The backward walks of the two chains of a bidirectional tanh-RNN
    layer: ``chain_a`` and ``chain_b`` are operand tuples of
    :func:`rnn_tanh_bwd_scan` over the same lengths tensor; returns its
    result for each. On the card both share one launch where the plan
    allows."""
    a, b = walks.run(RNN_TANH_BWD_SCAN, [chain_a, chain_b], [reverse_a, reverse_b], design)
    return a, b


RNN_TANH_BWD_SCAN = walks.Walk(
    check=_check_bwd_operands, plain=rnn_tanh_bwd_scan_plain,
    plan=persist_plan.plan_rnn_tanh_backward, plan_f32=persist_plan.plan_rnn_tanh_f32_backward,
    persistent=_bwd_persistent, step=walks.each(_bwd_step),
    persistent_f32=_bwd_f32_persistent, step_f32=_bwd_f32,
    counter=walks.counted(rnn_tanh_bwd_scan), lengths_at=2, w_at=3)
