"""The plans of the persistent float32 GRU backward walk (B4), LSTM forward
walk (B5, B6), LSTM backward walk (B7), tanh-RNN forward walk (B8) and
tanh-RNN backward walk (B9) (ops/persist_plan.py:plan_f32,
plan_gru_f32_backward, plan_lstm_f32_forward, plan_lstm_f32_backward,
plan_rnn_tanh_f32_forward, plan_rnn_tanh_f32_backward) with an H100's figures
passed in, the packed weight slices they read (ops/gru_cuda.py:f32_rows,
f32_slices), what their routes hand the C entries, and the walks' step
order: no CUDA device is needed.

Every unit of every chain is owned by exactly one block; the grid stays
within one block per SM; the work area, the state the walk keeps and the
resident share of the slice stay within the shared memory a block may use,
laid out as csrc/gru_f32.cu, csrc/lstm_f32.cu and csrc/rnn_tanh_f32.cu lay
them out; a shape that cannot fit is reported as "step" with a reason.
"""

import re

import numpy as np
import pytest
import torch

from danspeech_tpu_torch.ops import cuda_build, gru_cuda, lstm_cuda, rnn_tanh_cuda, walks
from danspeech_tpu_torch.ops import persist_plan as pp

SMS, SMEM = pp.H100_SMS, pp.H100_SMEM_OPTIN
PLANNERS = {"gru_backward": pp.plan_gru_f32_backward,
            "lstm_forward": pp.plan_lstm_f32_forward,
            "lstm_backward": pp.plan_lstm_f32_backward,
            "rnn_tanh_forward": pp.plan_rnn_tanh_f32_forward,
            "rnn_tanh_backward": pp.plan_rnn_tanh_f32_backward}

# (walk, hidden, batch, chains): the flagship's training layer (B4) one chain
# and the pair, at B = 128 and one clip; the 5x2000 model's uni training
# layer; LSTM5x800's training and serving layers (B5, B6), one chain and the
# pair, and one clip; LSTM5x800's training layer (B7) and Tanh5x800's serving
# and training layers (B8), one chain and the pair, and one clip; Tanh5x800's
# training layer (B9), one chain and the pair, its serving width and one clip;
# small and ragged shapes
FITS = [("gru_backward", 1200, 32, 2), ("gru_backward", 1200, 32, 1),
        ("gru_backward", 1200, 128, 2), ("gru_backward", 1200, 1, 2),
        ("gru_backward", 2000, 32, 1), ("gru_backward", 2000, 128, 2),
        ("gru_backward", 72, 5, 1), ("gru_backward", 72, 5, 2), ("gru_backward", 100, 3, 2),
        ("gru_backward", 72, 150, 2), ("gru_backward", 8, 1, 1), ("gru_backward", 1, 1, 1),
        ("lstm_forward", 800, 32, 2), ("lstm_forward", 800, 128, 2),
        ("lstm_forward", 800, 32, 1), ("lstm_forward", 800, 128, 1), ("lstm_forward", 800, 1, 2),
        ("lstm_forward", 70, 5, 2), ("lstm_forward", 72, 150, 2), ("lstm_forward", 2000, 128, 1),
        ("lstm_forward", 8, 1, 1), ("lstm_forward", 1, 1, 1),
        ("lstm_backward", 800, 32, 2), ("lstm_backward", 800, 32, 1),
        ("lstm_backward", 800, 128, 2), ("lstm_backward", 800, 128, 1),
        ("lstm_backward", 800, 1, 2), ("lstm_backward", 70, 5, 2), ("lstm_backward", 70, 5, 1),
        ("lstm_backward", 72, 150, 2), ("lstm_backward", 72, 150, 1),
        ("lstm_backward", 8, 1, 1), ("lstm_backward", 8, 5, 2), ("lstm_backward", 1, 1, 1),
        ("lstm_backward", 1, 150, 2),
        ("rnn_tanh_forward", 800, 128, 2), ("rnn_tanh_forward", 800, 128, 1),
        ("rnn_tanh_forward", 800, 32, 2), ("rnn_tanh_forward", 800, 32, 1),
        ("rnn_tanh_forward", 800, 1, 2), ("rnn_tanh_forward", 70, 5, 2),
        ("rnn_tanh_forward", 70, 5, 1), ("rnn_tanh_forward", 72, 150, 2),
        ("rnn_tanh_forward", 72, 150, 1), ("rnn_tanh_forward", 8, 1, 1),
        ("rnn_tanh_forward", 8, 5, 2), ("rnn_tanh_forward", 1, 1, 1),
        ("rnn_tanh_forward", 1, 150, 2), ("rnn_tanh_forward", 2000, 128, 1),
        ("rnn_tanh_backward", 800, 32, 2), ("rnn_tanh_backward", 800, 32, 1),
        ("rnn_tanh_backward", 800, 128, 2), ("rnn_tanh_backward", 800, 128, 1),
        ("rnn_tanh_backward", 800, 1, 2), ("rnn_tanh_backward", 70, 5, 2),
        ("rnn_tanh_backward", 70, 5, 1), ("rnn_tanh_backward", 72, 150, 2),
        ("rnn_tanh_backward", 72, 150, 1), ("rnn_tanh_backward", 8, 1, 1),
        ("rnn_tanh_backward", 8, 5, 2), ("rnn_tanh_backward", 1, 1, 1),
        ("rnn_tanh_backward", 1, 150, 2), ("rnn_tanh_backward", 2000, 128, 1),
        ("rnn_tanh_backward", 2000, 32, 2)]


def _id(shape):
    return "{}-H{}-B{}-chains{}".format(*shape)


def _plan(walk, hidden, batch, chains, sms=SMS, smem=SMEM):
    return PLANNERS[walk](hidden, batch, chains, sms, smem)


@pytest.mark.parametrize("walk,hidden,batch,chains", FITS, ids=[_id(s) for s in FITS])
def test_walk_plan_fits_the_card(walk, hidden, batch, chains):
    plan = _plan(walk, hidden, batch, chains)
    gates, depth_of, _, tile_of, state_of = pp.F32_WALKS[walk]
    assert plan.design == "persistent" and plan.reason == "fits"
    assert plan.walk == walk and plan.chains == chains
    assert plan.grid == plan.blocks_per_dir * chains <= SMS
    # the tiled product only: passes of at most 128 rows, padding rows below 8
    assert plan.product == "tiled" and plan.h_bytes == 0
    assert plan.rows_per_pass % pp.F32_TILE_ROWS == 0 and plan.rows_per_pass <= pp.F32_PASS_ROWS
    assert plan.padded_rows == plan.passes * plan.rows_per_pass >= batch
    assert (plan.passes - 1) * plan.rows_per_pass < batch
    work = (plan.rows_per_pass // 8) * (plan.units // 2)
    assert plan.k_splits in (1, 2, 4, 8) and plan.chunk_depth % plan.k_splits == 0
    assert work * plan.k_splits <= plan.threads <= pp.F32_MAX_THREADS
    assert plan.threads % 32 == 0 and plan.threads - work * plan.k_splits < 32
    assert plan.k_splits == pp.F32_MAX_SPLITS or 2 * work * plan.k_splits > pp.F32_MAX_THREADS
    # the product's depth (H, or 3H and 4H for the backward walks' carries) in
    # whole chunks
    assert plan.chunk_depth == pp.F32_CHUNK["tiled"] and plan.stages == pp.F32_STAGES
    assert plan.padded_depth % plan.chunk_depth == 0
    assert 0 <= plan.padded_depth - depth_of * hidden < plan.chunk_depth
    assert plan.resident_depth % plan.chunk_depth == 0
    assert 0 <= plan.resident_depth <= plan.padded_depth
    # shared memory: the work area (ring, or partial sums and the epilogue's
    # tile), the state kept for the whole walk, the resident slice
    cols = gates * plan.units
    assert plan.slice_bytes == plan.padded_depth * cols * 4
    ring = plan.stages * plan.chunk_depth * (plan.rows_per_pass + cols)
    sums = plan.k_splits * plan.rows_per_pass * cols + tile_of * plan.units * plan.rows_per_pass
    assert (plan.ring_bytes, plan.sums_bytes) == (4 * ring, 4 * sums)
    work_floats = -(-max(ring, sums) // 4) * 4
    state = -(-state_of * plan.units * plan.padded_rows // 4) * 4
    assert plan.state_bytes == 4 * state
    assert plan.smem_bytes == 4 * (work_floats + state + plan.resident_depth * cols)
    assert plan.smem_bytes <= SMEM - pp.STATIC_RESERVE
    if plan.resident_depth < plan.padded_depth:  # a whole chunk more would not fit
        assert plan.smem_bytes + 4 * plan.chunk_depth * cols > SMEM - pp.STATIC_RESERVE
    assert plan.c_args() == (
        plan.units, plan.blocks_per_dir, plan.rows_per_pass, plan.padded_rows,
        plan.padded_depth, plan.k_splits, plan.chunk_depth, plan.resident_depth, plan.threads,
        plan.smem_bytes, 0)


@pytest.mark.parametrize("walk,hidden,batch,chains", FITS, ids=[_id(s) for s in FITS])
def test_every_unit_of_every_chain_has_one_owner(walk, hidden, batch, chains):
    plan = _plan(walk, hidden, batch, chains)
    assert plan.units % pp.F32_TILE_UNITS == 0
    assert (plan.blocks_per_dir - 1) * plan.units < hidden <= plan.blocks_per_dir * plan.units
    owners = {}
    for block in range(plan.grid):  # chain c's blocks are c * blocks .. (c + 1) * blocks - 1
        chain, k = divmod(block, plan.blocks_per_dir)
        for j in range(k * plan.units, min((k + 1) * plan.units, hidden)):
            assert plan.owner(j) == k and (chain, j) not in owners
            owners[(chain, j)] = block
    assert sorted(owners) == [(c, j) for c in range(chains) for j in range(hidden)]


@pytest.mark.parametrize(
    "walk,hidden,batch,chains,units,grid,threads,k_splits,rows,depth,resident,smem,ring,sums", [
        # B4's pair at the flagship's training layer: 20 units a block, 60
        # blocks a chain; 3648 x 20 x 4 B = 285 KB of slice, 68% resident
        ("gru_backward", 1200, 32, 2, 20, 120, 320, 8, 32, 3648, 2496, 230400, 26624, 28160),
        # one chain: half the units a block, the whole slice resident
        ("gru_backward", 1200, 32, 1, 10, 120, 160, 8, 32, 3648, 3648, 168704, 21504, 14080),
        # LSTM5x800's training pair (B6): the partial sums (58 KB) lie over
        # the ring (44 KB) and are the larger, 85% resident
        ("lstm_forward", 800, 32, 2, 14, 116, 224, 8, 32, 832, 704, 218624, 45056, 59136),
        # its serving pair (B5): a ring of 92 KB, 69% resident
        ("lstm_forward", 800, 128, 2, 14, 116, 224, 2, 128, 832, 576, 230400, 94208, 64512),
        ("lstm_forward", 800, 128, 1, 8, 100, 256, 4, 128, 832, 832, 192512, 81920, 69632),
        ("lstm_forward", 800, 32, 1, 8, 100, 128, 8, 32, 832, 832, 141312, 32768, 33792),
        # LSTM5x800's training pair (B7): rows of w_hh over 4H, 179 KB of
        # slice a block, the whole of it resident beside the two carries
        ("lstm_backward", 800, 32, 2, 14, 116, 224, 8, 32, 3200, 3200, 206336, 23552, 21504),
        ("lstm_backward", 800, 32, 1, 8, 100, 128, 8, 32, 3200, 3200, 124928, 20480, 12288),
        # at B = 128 the carries (2 x 14 x 128 floats) and the ring leave 80%
        ("lstm_backward", 800, 128, 2, 14, 116, 224, 2, 128, 3200, 2560, 230400, 72704, 43008),
        # Tanh5x800's serving pair (B8): 47 KB of slice a block, all resident
        ("rnn_tanh_forward", 800, 128, 2, 14, 116, 224, 2, 128, 832, 832, 119296, 72704,
         21504),
        ("rnn_tanh_forward", 800, 32, 2, 14, 116, 224, 8, 32, 832, 832, 70144, 23552, 16128),
        ("rnn_tanh_forward", 800, 128, 1, 8, 100, 256, 4, 128, 832, 832, 96256, 69632, 20480),
        # Tanh5x800's training pair (B9): rows of w_hh over H, 47 KB of slice
        # a block, all resident beside the partial carry (14 x 32 floats)
        ("rnn_tanh_backward", 800, 32, 2, 14, 116, 224, 8, 32, 832, 832, 71936, 23552,
         16128),
        ("rnn_tanh_backward", 800, 32, 1, 8, 100, 128, 8, 32, 832, 832, 48128, 20480, 9216),
        ("rnn_tanh_backward", 800, 128, 2, 14, 116, 224, 2, 128, 832, 832, 126464, 72704,
         21504),
    ])
def test_walk_plan_at_the_path_shapes(walk, hidden, batch, chains, units, grid, threads,
                                      k_splits, rows, depth, resident, smem, ring, sums):
    plan = _plan(walk, hidden, batch, chains)
    assert (plan.design, plan.units, plan.grid, plan.threads, plan.k_splits,
            plan.rows_per_pass, plan.padded_depth, plan.resident_depth, plan.smem_bytes,
            plan.ring_bytes, plan.sums_bytes) == (
        "persistent", units, grid, threads, k_splits, rows, depth, resident, smem, ring, sums)


@pytest.mark.parametrize("walk,args,reason", [
    ("gru_backward", (1200, 32, 2, 1, SMEM), "2 chains on 1 SMs"),
    ("lstm_forward", (800, 32, 2, 1, SMEM), "2 chains on 1 SMs"),
    # the ring and the carry alone exceed 48 KB
    ("gru_backward", (1200, 128, 2, SMS, 48 * 1024), "state 10240 B"),
    ("lstm_forward", (800, 128, 2, SMS, 40 * 1024), "ring and sums 94208 B"),
    # 122 units a block: 976 threads of tiles
    ("gru_backward", (8000, 128, 2, SMS, SMEM), "976 threads"),
    ("lstm_forward", (8000, 128, 2, SMS, SMEM), "976 threads"),
    ("lstm_backward", (800, 32, 2, 1, SMEM), "2 chains on 1 SMs"),
    ("rnn_tanh_forward", (800, 128, 2, 1, SMEM), "2 chains on 1 SMs"),
    # the ring and the two carries alone exceed 64 KB
    ("lstm_backward", (800, 128, 2, SMS, 64 * 1024), "state 14336 B"),
    ("rnn_tanh_forward", (800, 128, 2, SMS, 40 * 1024), "ring and sums 72704 B"),
    ("lstm_backward", (8000, 128, 2, SMS, SMEM), "976 threads"),
    ("rnn_tanh_forward", (8000, 128, 2, SMS, SMEM), "976 threads"),
    ("rnn_tanh_backward", (800, 32, 2, 1, SMEM), "2 chains on 1 SMs"),
    # the ring and the carry alone exceed 64 KB
    ("rnn_tanh_backward", (800, 128, 2, SMS, 64 * 1024), "state 7168 B"),
    ("rnn_tanh_backward", (8000, 128, 2, SMS, SMEM), "976 threads"),
])
def test_walk_plan_takes_the_step_design_where_it_cannot_fit(walk, args, reason):
    plan = PLANNERS[walk](*args)
    assert plan.design == "step" and reason in plan.reason and plan.walk == walk
    assert walks.choose(None, plan) == "step" and walks.choose("step", plan) == "step"
    with pytest.raises(ValueError, match="does not fit"):
        walks.choose("persistent", plan)


@pytest.mark.parametrize("args", [("gru_backward", 0, 1, 1), ("lstm_forward", 8, 0, 1),
                                  ("gru_backward", 8, 1, 0), ("lstm_forward", 8, 1, 3),
                                  ("rnn_forward", 8, 1, 1)])
def test_walk_plan_refuses_bad_shapes_and_walks(args):
    with pytest.raises(ValueError):
        pp.plan_f32(*args, SMS, SMEM)


def _source(name):
    with open(f"{cuda_build.CSRC_DIR}/{name}") as f:
        return f.read()


@pytest.mark.parametrize("constant,define", [("F32_STAGES", "FP_STAGES"),
                                             ("F32_MAX_THREADS", "FP_MAX_THREADS")])
def test_walk_plan_constants_mirror_the_kernel(constant, define):
    """The shared header of the walks is compiled with the stages and the
    threads the plan sizes a block with, and every walk's source includes
    it."""
    m = re.findall(rf"^#define {define} (\d+)", _source("f32_walk.cuh"), re.M)
    assert len(m) == 1 and int(m[0]) == getattr(pp, constant)
    for name in ("gru_f32.cu", "lstm_f32.cu", "rnn_tanh_f32.cu"):
        assert '#include "f32_walk.cuh"' in _source(name)


@pytest.mark.parametrize("walk,source,kernel,work", [
    ("gru_forward", "gru_f32.cu", "gru_f32_persist_kernel",
     "fp_work_floats(q, 3 * q.U, dot ? 0 : q.RB, q.U * q.RB)"),
    ("gru_backward", "gru_f32.cu", "gru_f32_bwd_persist_kernel",
     "fp_work_floats(q, q.U, q.RB, 3 * q.U * q.RB)"),
    ("lstm_forward", "lstm_f32.cu", "lstm_f32_persist_kernel",
     "fp_work_floats(q, 4 * q.U, q.RB, q.U * q.RB)"),
    ("lstm_backward", "lstm_f32.cu", "lstm_f32_bwd_persist_kernel",
     "fp_work_floats(q, q.U, q.RB, 4 * q.U * q.RB)"),
    ("rnn_tanh_forward", "rnn_tanh_f32.cu", "rnn_tanh_f32_persist_kernel",
     "fp_work_floats(q, q.U, q.RB, q.U * q.RB)"),
    ("rnn_tanh_backward", "rnn_tanh_f32.cu", "rnn_tanh_f32_bwd_persist_kernel",
     "fp_work_floats(q, q.U, q.RB, q.U * q.RB)"),
])
def test_walk_table_mirrors_the_kernels(walk, source, kernel, work):
    """F32_WALKS' gate columns are the kernel's product instance, its tile
    the work area's, and its state what the kernel keeps beside it: one
    plane of U x Bp floats a state."""
    gates, _, has_dot, tile_of, state_of = pp.F32_WALKS[walk]
    text = _source(source)
    body = text[text.index(f"{kernel}(") :]
    body = body[: body.index("\n}\n")]
    assert f"fp_tiled_product<{gates}>" in body
    assert ("fp_dot_product<" in body) == has_dot
    assert work in text and f"{tile_of if tile_of > 1 else ''}" in work
    assert body.count("fp_up4(U * Bp)") == state_of


@pytest.mark.parametrize("hidden,units,blocks,depth", [(7, 2, 4, 64), (72, 2, 36, 256),
                                                       (100, 20, 5, 320), (64, 16, 4, 192)])
def test_f32_rows_pack_each_blocks_rows_depth_major(hidden, units, blocks, depth):
    """B4's slice: block k's column u at depth d is w_hh[k * units + u, d]
    (the rows of w_hh, the columns of w_hh^T); zeros for units past H and
    depths past 3H."""
    gen = torch.Generator().manual_seed(hidden)
    w = torch.randn(hidden, 3 * hidden, generator=gen)
    packed = gru_cuda.f32_rows(w, units, blocks, depth)
    assert packed.shape == (blocks, depth, units) and packed.is_contiguous()
    want = torch.zeros(blocks, depth, units)
    for k in range(blocks):
        for u in range(units):
            j = k * units + u
            if j < hidden:
                want[k, : 3 * hidden, u] = w[j]
    assert torch.equal(packed, want)


@pytest.mark.parametrize("hidden,units,blocks,depth", [(7, 2, 4, 64), (72, 14, 6, 128),
                                                       (70, 8, 9, 128)])
def test_f32_slices_pack_the_four_lstm_gates(hidden, units, blocks, depth):
    """B5/B6's slice: block k's column g * units + u at depth d is w_hh[d, g H
    + k units + u], the gates i, f, g, o in order; zeros past H."""
    gen = torch.Generator().manual_seed(hidden + 1)
    w = torch.randn(hidden, 4 * hidden, generator=gen)
    packed = gru_cuda.f32_slices(w, units, blocks, depth)
    assert packed.shape == (blocks, depth, 4 * units) and packed.is_contiguous()
    want = torch.zeros(blocks, depth, 4 * units)
    for k in range(blocks):
        for g in range(4):
            for u in range(units):
                j = k * units + u
                if j < hidden:
                    want[k, :hidden, g * units + u] = w[:, g * hidden + j]
    assert torch.equal(packed, want)


@pytest.mark.parametrize("hidden,units,blocks,depth", [(7, 2, 4, 64), (70, 2, 35, 320),
                                                       (72, 14, 6, 320)])
def test_f32_rows_pack_each_blocks_rows_of_the_four_lstm_gates(hidden, units, blocks, depth):
    """B7's slice: block k's column u at depth d is w_hh[k * units + u, d]
    over the four gates' depth 4H; zeros for units past H and depths past
    4H."""
    gen = torch.Generator().manual_seed(hidden + 2)
    w = torch.randn(hidden, 4 * hidden, generator=gen)
    packed = gru_cuda.f32_rows(w, units, blocks, depth)
    assert packed.shape == (blocks, depth, units) and packed.is_contiguous()
    want = torch.zeros(blocks, depth, units)
    for k in range(blocks):
        for u in range(units):
            j = k * units + u
            if j < hidden:
                want[k, : 4 * hidden, u] = w[j]
    assert torch.equal(packed, want)


@pytest.mark.parametrize("hidden,units,blocks,depth", [(7, 2, 4, 64), (70, 2, 35, 128),
                                                       (72, 14, 6, 128)])
def test_f32_slices_pack_the_one_tanh_gate(hidden, units, blocks, depth):
    """B8's slice: block k's column u at depth d is w_hh[d, k units + u];
    zeros past H."""
    gen = torch.Generator().manual_seed(hidden + 3)
    w = torch.randn(hidden, hidden, generator=gen)
    packed = gru_cuda.f32_slices(w, units, blocks, depth)
    assert packed.shape == (blocks, depth, units) and packed.is_contiguous()
    want = torch.zeros(blocks, depth, units)
    for k in range(blocks):
        for u in range(units):
            j = k * units + u
            if j < hidden:
                want[k, :hidden, u] = w[:, j]
    assert torch.equal(packed, want)


@pytest.mark.parametrize("hidden,units,blocks,depth", [(7, 2, 4, 64), (70, 2, 35, 128),
                                                       (72, 14, 6, 128), (800, 14, 58, 832)])
def test_f32_rows_pack_each_blocks_rows_of_the_tanh_weights(hidden, units, blocks, depth):
    """B9's slice: block k's column u at depth d is w_hh[k * units + u, d],
    the rows of the square w_hh (the columns of w_hh^T) over a depth of H;
    zeros for units past H and depths past H."""
    gen = torch.Generator().manual_seed(hidden + 4)
    w = torch.randn(hidden, hidden, generator=gen)
    packed = gru_cuda.f32_rows(w, units, blocks, depth)
    assert packed.shape == (blocks, depth, units) and packed.is_contiguous()
    want = torch.zeros(blocks, depth, units)
    for k in range(blocks):
        for u in range(units):
            j = k * units + u
            if j < hidden:
                want[k, :hidden, u] = w[j]
    assert torch.equal(packed, want)


def test_f32_rows_are_kept_per_tensor_apart_from_the_forward_slices():
    w = torch.randn(8, 24)
    rows = gru_cuda.f32_rows(w, 2, 4, 64)
    slices = gru_cuda.f32_slices(w, 2, 4, 64)  # the same cut, the other layout
    assert gru_cuda.f32_rows(w, 2, 4, 64) is rows and rows.shape == (4, 64, 2)
    assert slices.shape == (4, 64, 6)
    with torch.no_grad():
        w.mul_(2.0)  # an optimizer step: a new version
    again = gru_cuda.f32_rows(w, 2, 4, 64)
    assert again is not rows and torch.equal(again, 2.0 * rows)
    key = (id(w), 2, 4, 64)
    assert key in gru_cuda._f32_rows
    del w, rows, again, slices
    assert key not in gru_cuda._f32_rows


# ---------------------------------------------------------------------------
# What the persistent routes hand their C entries (CPU tensors, no launch)
# ---------------------------------------------------------------------------


def _c_signature(source, fn_name):
    """(pointer parameters, int parameters) of ``extern "C" int fn_name(...)``
    in csrc/``source``, the trailing stream left out; pointers come first."""
    text = re.sub(r"//[^\n]*", "", _source(source))
    m = re.search(r'extern "C" int ' + fn_name + r"\((.*?)\)\s*\{", text, re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    assert params[-1] == "void* stream"
    kinds = ["ptr" if "*" in p else "int" for p in params[:-1]]
    assert kinds == sorted(kinds, key=lambda k: k != "ptr"), "pointers first, then ints"
    names = [p.split("*")[-1].strip() for p in params[:-1]]
    return kinds.count("ptr"), kinds.count("int"), names


def _record_launch(monkeypatch, at, shape):
    """Stands in for cuda_build.bind and .call; returns the record: the bound
    entry, the arguments, and a copy of the float32 buffer at argument
    ``at`` as the entry would read it."""
    import ctypes

    rec = {}

    def call(fn, name, dev, *args):
        rec["args"] = args
        ptr = ctypes.cast(args[at], ctypes.POINTER(ctypes.c_float))
        rec["buffer"] = np.ctypeslib.as_array(ptr, shape=shape).copy()

    monkeypatch.setattr(cuda_build, "bind", lambda *a: rec.setdefault("bound", a))
    monkeypatch.setattr(cuda_build, "call", call)
    return rec


T, B, H = 6, 3, 16


@pytest.mark.parametrize("chains,reverses", [(1, [True]), (1, [False]), (2, [True, False])])
def test_persistent_bwd_route_matches_its_c_entry(monkeypatch, chains, reverses):
    """B4, persistent: the entry gets each chain's gx, hprev, dout, lengths,
    w_hh (for the gate recompute), packed rows and biases (one chain fills
    both), a zeroed exchange buffer, dh_last in the buffers that come back as
    dh0, the dgx and dghn outputs, one zeroed barrier a chain, then (T, B, H,
    reverse_a, reverse_b, chains) and the plan's ints."""
    plan = pp.plan_gru_f32_backward(H, B, chains, SMS, SMEM)
    n_ptr, n_int, names = _c_signature("gru_f32.cu", "gru_f32_bwd_persist_launch")
    assert (n_ptr, n_int) == (23, 17)
    rec = _record_launch(monkeypatch, names.index("dg"),
                         (2, chains, plan.padded_depth, plan.padded_rows))
    lengths = torch.tensor([6, 2, 0], dtype=torch.int32)
    ops = [(torch.randn(T, B, 3 * H), torch.randn(T, B, H), torch.randn(T, B, H), lengths,
            torch.randn(H, 3 * H), torch.randn(3 * H), torch.randn(3 * H), torch.randn(B, H))
           for _ in range(chains)]
    outs = gru_cuda._bwd_f32_persistent(ops, reverses, plan)
    source, fn_name, bound_ptr, bound_int = rec["bound"]
    assert (source, fn_name, bound_ptr, bound_int) == ("gru_f32", "gru_f32_bwd_persist_launch",
                                                        n_ptr, n_int)
    args = dict(zip(names, rec["args"]))
    assert len(rec["args"]) == n_ptr + n_int
    assert list(rec["args"][n_ptr:]) == [T, B, H, int(reverses[0]), int(reverses[-1]), chains,
                                         *plan.c_args()]
    rows = [gru_cuda.f32_rows(c[4], plan.units, plan.blocks_per_dir, plan.padded_depth)
            for c in ops]
    last = ops[-1]
    for k, (i, name) in enumerate([(0, "gx"), (1, "hprev"), (2, "dout"), (4, "w_hh"),
                                   (5, "b_ih"), (6, "b_hh")]):
        assert (args[f"{name}_a"], args[f"{name}_b"]) == (ops[0][i].data_ptr(),
                                                          last[i].data_ptr())
    assert args["lengths"] == lengths.data_ptr()
    assert (args["wp_a"], args["wp_b"]) == (rows[0].data_ptr(), rows[-1].data_ptr())
    assert not rec["buffer"].any()
    assert (args["dgx_a"], args["dghn_a"], args["dh_a"]) == tuple(
        t.data_ptr() for t in outs[0])
    assert (args["dgx_b"], args["dghn_b"], args["dh_b"]) == tuple(
        t.data_ptr() for t in outs[-1])
    for (dgx, dghn, dh0), c in zip(outs, ops):
        assert (tuple(dgx.shape), tuple(dghn.shape)) == ((T, B, 3 * H), (T, B, H))
        assert torch.equal(dh0, c[7]) and dh0.data_ptr() != c[7].data_ptr()


@pytest.mark.parametrize("with_cell", [False, True])
@pytest.mark.parametrize("chains,reverses", [(1, [False]), (1, [True]), (2, [False, True])])
def test_persistent_lstm_route_matches_its_c_entry(monkeypatch, chains, reverses, with_cell):
    """B5 and B6, persistent: the entry gets each chain's gx, lengths, packed
    slices and b_hh, the state with each chain's h0 transposed in buffer 0
    and zeros elsewhere, c0 in the buffers that come back as c_last, h_last,
    out and (B6 only; null for B5) c_seq, one zeroed barrier a chain, then
    (T, B, H, reverse_a, reverse_b, chains) and the plan's ints."""
    plan = pp.plan_lstm_f32_forward(H, B, chains, SMS, SMEM)
    n_ptr, n_int, names = _c_signature("lstm_f32.cu", "lstm_f32_persist_launch")
    assert (n_ptr, n_int) == (17, 17)
    rec = _record_launch(monkeypatch, names.index("hx"),
                         (2, chains, plan.padded_depth, plan.padded_rows))
    lengths = torch.tensor([6, 2, 0], dtype=torch.int32)
    ops = [(torch.randn(T, B, 4 * H), lengths, torch.randn(H, 4 * H), torch.randn(4 * H),
            torch.randn(B, H), torch.randn(B, H)) for _ in range(chains)]
    outs = lstm_cuda._scan_f32_persistent(ops, reverses, with_cell, plan)
    assert rec["bound"] == ("lstm_f32", "lstm_f32_persist_launch", n_ptr, n_int)
    args = dict(zip(names, rec["args"]))
    assert list(rec["args"][n_ptr:]) == [T, B, H, int(reverses[0]), int(reverses[-1]), chains,
                                         *plan.c_args()]
    slices = [gru_cuda.f32_slices(c[2], plan.units, plan.blocks_per_dir, plan.padded_depth)
              for c in ops]
    assert (args["gx_a"], args["gx_b"]) == (ops[0][0].data_ptr(), ops[-1][0].data_ptr())
    assert (args["wp_a"], args["wp_b"]) == (slices[0].data_ptr(), slices[-1].data_ptr())
    assert (args["b_hh_a"], args["b_hh_b"]) == (ops[0][3].data_ptr(), ops[-1][3].data_ptr())
    want = np.zeros((2, chains, plan.padded_depth, plan.padded_rows), dtype=np.float32)
    for k, c in enumerate(ops):
        want[0, k, :H, :B] = c[4].t().numpy()
    assert np.array_equal(rec["buffer"], want)
    for k, o in zip("ab", (outs[0], outs[-1])):
        out, cseq = o[0], (o[1] if with_cell else None)
        h_last, c_last = o[-2], o[-1]
        assert args[f"out_{k}"] == out.data_ptr() and args[f"h_last_{k}"] == h_last.data_ptr()
        assert args[f"c_{k}"] == c_last.data_ptr()
        assert args[f"cseq_{k}"] == (cseq.data_ptr() if with_cell else None)
    for o, c in zip(outs, ops):
        assert len(o) == (4 if with_cell else 3)
        assert torch.equal(o[-1], c[5]) and o[-1].data_ptr() != c[5].data_ptr()


@pytest.mark.parametrize("chains,reverses", [(1, [True]), (1, [False]), (2, [True, False])])
def test_persistent_lstm_bwd_route_matches_its_c_entry(monkeypatch, chains, reverses):
    """B7, persistent: the entry gets each chain's gx, hprev, cprev, dout,
    lengths, w_hh (for the gate recompute), packed rows and b_hh (one chain
    fills both), a zeroed exchange buffer, zeroed dh and dc that come back
    as dh0 and dc0, the dg4 outputs, one zeroed barrier a chain, then (T, B,
    H, reverse_a, reverse_b, chains) and the plan's ints."""
    plan = pp.plan_lstm_f32_backward(H, B, chains, SMS, SMEM)
    n_ptr, n_int, names = _c_signature("lstm_f32.cu", "lstm_f32_bwd_persist_launch")
    assert (n_ptr, n_int) == (23, 17)
    rec = _record_launch(monkeypatch, names.index("dg"),
                         (2, chains, plan.padded_depth, plan.padded_rows))
    lengths = torch.tensor([6, 2, 0], dtype=torch.int32)
    ops = [(torch.randn(T, B, 4 * H), torch.randn(T, B, H), torch.randn(T, B, H),
            torch.randn(T, B, H), lengths, torch.randn(H, 4 * H), torch.randn(4 * H))
           for _ in range(chains)]
    outs = lstm_cuda._bwd_f32_persistent(ops, reverses, plan)
    assert rec["bound"] == ("lstm_f32", "lstm_f32_bwd_persist_launch", n_ptr, n_int)
    args = dict(zip(names, rec["args"]))
    assert len(rec["args"]) == n_ptr + n_int
    assert list(rec["args"][n_ptr:]) == [T, B, H, int(reverses[0]), int(reverses[-1]), chains,
                                         *plan.c_args()]
    rows = [gru_cuda.f32_rows(c[5], plan.units, plan.blocks_per_dir, plan.padded_depth)
            for c in ops]
    last = ops[-1]
    for i, name in [(0, "gx"), (1, "hprev"), (2, "cprev"), (3, "dout"), (5, "w_hh"),
                    (6, "b_hh")]:
        assert (args[f"{name}_a"], args[f"{name}_b"]) == (ops[0][i].data_ptr(),
                                                          last[i].data_ptr())
    assert args["lengths"] == lengths.data_ptr()
    assert (args["wp_a"], args["wp_b"]) == (rows[0].data_ptr(), rows[-1].data_ptr())
    assert not rec["buffer"].any()
    for k, o in zip("ab", (outs[0], outs[-1])):
        assert (args[f"dg4_{k}"], args[f"dh_{k}"], args[f"dc_{k}"]) == tuple(
            t.data_ptr() for t in o)
    for dg4, dh0, dc0 in outs:
        assert tuple(dg4.shape) == (T, B, 4 * H)
        assert not dh0.any() and not dc0.any() and dh0.shape == dc0.shape == (B, H)


@pytest.mark.parametrize("chains,reverses", [(1, [False]), (1, [True]), (2, [False, True])])
def test_persistent_tanh_route_matches_its_c_entry(monkeypatch, chains, reverses):
    """B8, persistent: the entry gets each chain's gx, lengths and packed
    slices (one chain fills both), the state zeroed (h0 = 0), the buffers
    that come back as h_last and out, one zeroed barrier a chain, then (T,
    B, H, reverse_a, reverse_b, chains) and the plan's ints."""
    plan = pp.plan_rnn_tanh_f32_forward(H, B, chains, SMS, SMEM)
    n_ptr, n_int, names = _c_signature("rnn_tanh_f32.cu", "rnn_tanh_f32_persist_launch")
    assert (n_ptr, n_int) == (11, 17)
    rec = _record_launch(monkeypatch, names.index("hx"),
                         (2, chains, plan.padded_depth, plan.padded_rows))
    lengths = torch.tensor([6, 2, 0], dtype=torch.int32)
    ops = [(torch.randn(T, B, H), lengths, torch.randn(H, H)) for _ in range(chains)]
    outs = rnn_tanh_cuda._scan_f32_persistent(ops, reverses, plan)
    assert rec["bound"] == ("rnn_tanh_f32", "rnn_tanh_f32_persist_launch", n_ptr, n_int)
    args = dict(zip(names, rec["args"]))
    assert len(rec["args"]) == n_ptr + n_int
    assert list(rec["args"][n_ptr:]) == [T, B, H, int(reverses[0]), int(reverses[-1]), chains,
                                         *plan.c_args()]
    slices = [gru_cuda.f32_slices(c[2], plan.units, plan.blocks_per_dir, plan.padded_depth)
              for c in ops]
    assert (args["gx_a"], args["gx_b"]) == (ops[0][0].data_ptr(), ops[-1][0].data_ptr())
    assert args["lengths"] == lengths.data_ptr()
    assert (args["wp_a"], args["wp_b"]) == (slices[0].data_ptr(), slices[-1].data_ptr())
    assert not rec["buffer"].any()
    for k, (out, h_last) in zip("ab", (outs[0], outs[-1])):
        assert (args[f"out_{k}"], args[f"h_last_{k}"]) == (out.data_ptr(), h_last.data_ptr())
    for out, h_last in outs:
        assert (tuple(out.shape), tuple(h_last.shape)) == ((T, B, H), (B, H))


@pytest.mark.parametrize("chains,reverses", [(1, [True]), (1, [False]), (2, [True, False])])
def test_persistent_tanh_bwd_route_matches_its_c_entry(monkeypatch, chains, reverses):
    """B9, persistent: the entry gets each chain's out and dout, lengths and
    packed rows of w_hh (one chain fills both), a zeroed exchange buffer,
    the buffers that come back as dh0 and dpre, one zeroed barrier a chain,
    then (T, B, H, reverse_a, reverse_b, chains) and the plan's ints."""
    plan = pp.plan_rnn_tanh_f32_backward(H, B, chains, SMS, SMEM)
    n_ptr, n_int, names = _c_signature("rnn_tanh_f32.cu", "rnn_tanh_f32_bwd_persist_launch")
    assert (n_ptr, n_int) == (13, 17)
    rec = _record_launch(monkeypatch, names.index("dx"),
                         (2, chains, plan.padded_depth, plan.padded_rows))
    lengths = torch.tensor([6, 2, 0], dtype=torch.int32)
    ops = [(torch.rand(T, B, H) * 2 - 1, torch.randn(T, B, H), lengths, torch.randn(H, H))
           for _ in range(chains)]
    outs = rnn_tanh_cuda._bwd_f32_persistent(ops, reverses, plan)
    assert rec["bound"] == ("rnn_tanh_f32", "rnn_tanh_f32_bwd_persist_launch", n_ptr, n_int)
    args = dict(zip(names, rec["args"]))
    assert len(rec["args"]) == n_ptr + n_int
    assert list(rec["args"][n_ptr:]) == [T, B, H, int(reverses[0]), int(reverses[-1]), chains,
                                         *plan.c_args()]
    rows = [gru_cuda.f32_rows(c[3], plan.units, plan.blocks_per_dir, plan.padded_depth)
            for c in ops]
    for i, name in [(0, "out"), (1, "dout")]:
        assert (args[f"{name}_a"], args[f"{name}_b"]) == (ops[0][i].data_ptr(),
                                                          ops[-1][i].data_ptr())
    assert args["lengths"] == lengths.data_ptr()
    assert (args["wp_a"], args["wp_b"]) == (rows[0].data_ptr(), rows[-1].data_ptr())
    assert not rec["buffer"].any()
    for k, (dpre, dh0) in zip("ab", (outs[0], outs[-1])):
        assert (args[f"dpre_{k}"], args[f"dh_{k}"]) == (dpre.data_ptr(), dh0.data_ptr())
    for dpre, dh0 in outs:
        assert (tuple(dpre.shape), tuple(dh0.shape)) == ((T, B, H), (B, H))


# ---------------------------------------------------------------------------
# The walks' step order, as the kernels take it, against the plain versions
# ---------------------------------------------------------------------------


def _bwd_walk_as_the_kernel_takes_it(gx, hprev, dout, lengths, w_hh, b_ih, b_hh, dh_last,
                                     reverse, plan):
    """gru_f32_bwd_persist_kernel's walk in plain tensor ops: the carry
    through the packed rows and the exchanged, transposed and padded dgh,
    only the steps before the longest length walked (zeros after it), the
    carry kept per block, one last pass for dh0."""
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    rows = gru_cuda.f32_rows(w_hh, plan.units, plan.blocks_per_dir, plan.padded_depth)
    dg = torch.zeros(plan.padded_depth, plan.padded_rows)
    part = torch.zeros(plan.blocks_per_dir * plan.units, plan.padded_rows)
    part[:hidden, :batch] = dh_last.t()
    dgx = torch.zeros(t_max, batch, 3 * hidden)
    dghn = torch.zeros(t_max, batch, hidden)
    n = int(lengths.max())
    for s in range(n + 1):
        # each block's carry: its columns of dg^T @ rows over the whole depth
        acc = torch.cat([dg.t() @ rows[k] for k in range(plan.blocks_per_dir)], 1).t()
        dh = part + acc if s > 0 else part.clone()
        if s == n:
            return dgx, dghn, dh[:hidden, :batch].t()
        t = n - 1 - s if reverse else s
        m = (lengths > t).float()[None, :]
        gh = hprev[t] @ w_hh + b_hh
        x = gx[t] + b_ih
        r = torch.sigmoid(x[:, :hidden] + gh[:, :hidden])
        z = torch.sigmoid(x[:, hidden:2 * hidden] + gh[:, hidden:2 * hidden])
        ghn = gh[:, 2 * hidden:]
        nn_ = torch.tanh(x[:, 2 * hidden:] + r * ghn)
        d = dh[:hidden, :batch].t()
        dhnew = m.t() * (d + dout[t])
        dpre_n = dhnew * (1 - z) * (1 - nn_ * nn_)
        dpre_r = dpre_n * ghn * r * (1 - r)
        dpre_z = dhnew * (hprev[t] - nn_) * z * (1 - z)
        dgx[t] = torch.cat([dpre_r, dpre_z, dpre_n], 1)
        dghn[t] = dpre_n * r
        new = torch.zeros_like(part)
        new[:hidden, :batch] = (dhnew * z + (1 - m.t()) * d).t()
        part = new
        dg = torch.zeros_like(dg)
        dg[: 3 * hidden, :batch] = torch.cat([dpre_r, dpre_z, dpre_n * r], 1).t()


@pytest.mark.parametrize("reverse", [True, False])
@pytest.mark.parametrize("lengths", [[6, 2, 0], [4, 4, 1], [0, 0, 0], [6, 6, 6]])
def test_bwd_walk_skipping_the_steps_past_every_length_matches_the_plain_walk(reverse,
                                                                              lengths):
    """The persistent backward walk walks t < max(lengths) only (reversed or
    not) and writes zeros at the later steps: there every row is past its
    length, dL/dh passes through unchanged and dgh is zero, so the carry
    into the next walked step, and dh0, are those of the full walk."""
    gen = torch.Generator().manual_seed(sum(lengths) + reverse)
    lens = torch.tensor(lengths, dtype=torch.int32)
    args = (torch.randn(T, B, 3 * H, generator=gen), torch.rand(T, B, H, generator=gen) - 0.5,
            torch.randn(T, B, H, generator=gen), lens,
            torch.randn(H, 3 * H, generator=gen) / 4, torch.randn(3 * H, generator=gen),
            torch.randn(3 * H, generator=gen), torch.randn(B, H, generator=gen))
    plan = pp.plan_gru_f32_backward(H, B, 1, 4, SMEM)  # several blocks of a few units
    assert plan.blocks_per_dir > 1
    got = _bwd_walk_as_the_kernel_takes_it(*args, reverse, plan)
    want = gru_cuda.gru_bwd_scan_plain(*args, reverse=reverse)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def _lstm_walk_as_the_kernel_takes_it(gx, lengths, w_hh, b_hh, h0, c0, reverse, plan):
    """lstm_f32_persist_kernel's walk in plain tensor ops: the gate sums
    through the packed slices and the exchanged, transposed and padded h, c
    kept per block, only the steps before the longest length walked."""
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    slices = gru_cuda.f32_slices(w_hh, plan.units, plan.blocks_per_dir, plan.padded_depth)
    hx = torch.zeros(plan.padded_depth, plan.padded_rows)
    hx[:hidden, :batch] = h0.t()
    c = c0.clone()
    out = torch.zeros(t_max, batch, hidden)
    cseq = torch.zeros(t_max, batch, hidden)
    n = int(lengths.max())
    u = plan.units
    for s in range(n):
        t = n - 1 - s if reverse else s
        sums = torch.cat([hx.t() @ slices[k] for k in range(plan.blocks_per_dir)], 1)
        # block k's columns g * U + u back to the gate-major order of w_hh
        sums = sums.reshape(-1, plan.blocks_per_dir, 4, u).permute(0, 2, 1, 3).reshape(
            -1, 4, plan.blocks_per_dir * u)[:batch, :, :hidden].reshape(batch, 4 * hidden)
        pre = gx[t] + sums + b_hh
        i, f, g, o = (torch.sigmoid(pre[:, :hidden]), torch.sigmoid(pre[:, hidden:2 * hidden]),
                      torch.tanh(pre[:, 2 * hidden:3 * hidden]), torch.sigmoid(pre[:, 3 * hidden:]))
        hp = hx[:hidden, :batch].t()
        cn = f * c + i * g
        hn = o * torch.tanh(cn)
        valid = (lengths > t)[:, None]
        c = torch.where(valid, cn, c)
        out[t] = torch.where(valid, hn, torch.zeros_like(hn))
        cseq[t] = torch.where(valid, cn, torch.zeros_like(cn))
        hx = torch.zeros_like(hx)
        hx[:hidden, :batch] = torch.where(valid, hn, hp).t()
    return out, cseq, hx[:hidden, :batch].t(), c


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("lengths", [[6, 2, 0], [4, 4, 1], [0, 0, 0]])
def test_lstm_walk_skipping_the_steps_past_every_length_matches_the_plain_walk(reverse,
                                                                               lengths):
    """The persistent LSTM walk walks t < max(lengths) only (a reverse chain
    from max(lengths) - 1, its states h0, c0 until then) and writes zeros at
    the later steps: the same out, c_seq, h_last and c_last as the plain
    walk over every step."""
    gen = torch.Generator().manual_seed(sum(lengths) + 10 * reverse)
    lens = torch.tensor(lengths, dtype=torch.int32)
    args = (torch.randn(T, B, 4 * H, generator=gen) * 0.5, lens,
            torch.randn(H, 4 * H, generator=gen) / 4, torch.randn(4 * H, generator=gen),
            torch.rand(B, H, generator=gen) - 0.5, torch.rand(B, H, generator=gen) - 0.5)
    plan = pp.plan_lstm_f32_forward(H, B, 1, 4, SMEM)
    assert plan.blocks_per_dir > 1
    got = _lstm_walk_as_the_kernel_takes_it(*args, reverse, plan)
    want = lstm_cuda.lstm_scan_with_cell_plain(*args, reverse=reverse)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def _lstm_bwd_walk_as_the_kernel_takes_it(gx, hprev, cprev, dout, lengths, w_hh, b_hh,
                                          reverse, plan):
    """lstm_f32_bwd_persist_kernel's walk in plain tensor ops: the carry
    through the packed rows and the exchanged, transposed and padded dg4,
    only the steps before the longest length walked (zeros after it), the
    partial carry and the cell gradient kept per block, one last pass for
    dh0 (dc0 the cell gradient as it stands)."""
    t_max, batch, _ = gx.shape
    hidden = w_hh.shape[0]
    rows = gru_cuda.f32_rows(w_hh, plan.units, plan.blocks_per_dir, plan.padded_depth)
    dg = torch.zeros(plan.padded_depth, plan.padded_rows)
    part = torch.zeros(plan.blocks_per_dir * plan.units, plan.padded_rows)
    dcs = torch.zeros_like(part)
    dg4 = torch.zeros(t_max, batch, 4 * hidden)
    n = int(lengths.max())
    for s in range(n + 1):
        # each block's carry: its columns of dg^T @ rows over the whole depth
        acc = torch.cat([dg.t() @ rows[k] for k in range(plan.blocks_per_dir)], 1).t()
        dh = part + acc if s > 0 else part.clone()
        if s == n:
            return dg4, dh[:hidden, :batch].t(), dcs[:hidden, :batch].t()
        t = n - 1 - s if reverse else s
        m = (lengths > t).float()[:, None]
        pre = gx[t] + hprev[t] @ w_hh + b_hh
        i, f, g, o = (torch.sigmoid(pre[:, :hidden]), torch.sigmoid(pre[:, hidden:2 * hidden]),
                      torch.tanh(pre[:, 2 * hidden:3 * hidden]), torch.sigmoid(pre[:, 3 * hidden:]))
        cp = cprev[t]
        tc = torch.tanh(f * cp + i * g)
        d = dh[:hidden, :batch].t()
        dc = dcs[:hidden, :batch].t()
        dhnew = m * (d + dout[t])
        dcn = dhnew * o * (1 - tc * tc) + m * dc
        dg4[t] = torch.cat([dcn * g * i * (1 - i), dcn * cp * f * (1 - f), dcn * i * (1 - g * g),
                            dhnew * tc * o * (1 - o)], 1)
        part = torch.zeros_like(part)
        part[:hidden, :batch] = ((1 - m) * d).t()
        new_dc = torch.zeros_like(dcs)
        new_dc[:hidden, :batch] = (m * dcn * f + (1 - m) * dc).t()
        dcs = new_dc
        dg = torch.zeros_like(dg)
        dg[: 4 * hidden, :batch] = dg4[t].t()


@pytest.mark.parametrize("reverse", [True, False])
@pytest.mark.parametrize("lengths", [[6, 2, 0], [4, 4, 1], [0, 0, 0], [6, 6, 6]])
def test_lstm_bwd_walk_skipping_the_steps_past_every_length_matches_the_plain_walk(reverse,
                                                                                   lengths):
    """The persistent LSTM backward walk walks t < max(lengths) only
    (reversed or not) and writes zeros at the later steps: there every row
    is past its length, dL/dh and dL/dc pass through unchanged and dg4 is
    zero, so the carries into the next walked step, dh0 and dc0 are those
    of the full walk."""
    gen = torch.Generator().manual_seed(sum(lengths) + 20 * reverse)
    lens = torch.tensor(lengths, dtype=torch.int32)
    args = (torch.randn(T, B, 4 * H, generator=gen) * 0.5,
            torch.rand(T, B, H, generator=gen) - 0.5, torch.rand(T, B, H, generator=gen) - 0.5,
            torch.randn(T, B, H, generator=gen), lens, torch.randn(H, 4 * H, generator=gen) / 4,
            torch.randn(4 * H, generator=gen))
    plan = pp.plan_lstm_f32_backward(H, B, 1, 4, SMEM)  # several blocks of a few units
    assert plan.blocks_per_dir > 1
    got = _lstm_bwd_walk_as_the_kernel_takes_it(*args, reverse, plan)
    want = lstm_cuda.lstm_bwd_scan_plain(*args, reverse=reverse)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def _tanh_walk_as_the_kernel_takes_it(gx, lengths, w_hh, reverse, plan):
    """rnn_tanh_f32_persist_kernel's walk in plain tensor ops: the sums
    through the packed slices and the exchanged, transposed and padded h
    (zeros on entry), only the steps before the longest length walked (a
    reverse chain from there), h_last from the last buffer written."""
    t_max, batch, hidden = gx.shape
    slices = gru_cuda.f32_slices(w_hh, plan.units, plan.blocks_per_dir, plan.padded_depth)
    hx = torch.zeros(plan.padded_depth, plan.padded_rows)
    out = torch.zeros(t_max, batch, hidden)
    n = int(lengths.max())
    for s in range(n):
        t = n - 1 - s if reverse else s
        sums = torch.cat([hx.t() @ slices[k] for k in range(plan.blocks_per_dir)], 1)
        hn = torch.tanh(gx[t] + sums[:batch, :hidden])
        valid = (lengths > t)[:, None]
        out[t] = torch.where(valid, hn, torch.zeros_like(hn))
        new = torch.zeros_like(hx)
        new[:hidden, :batch] = torch.where(valid, hn, hx[:hidden, :batch].t()).t()
        hx = new
    return out, hx[:hidden, :batch].t()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("lengths", [[6, 2, 0], [4, 4, 1], [0, 0, 0], [6, 6, 6]])
def test_tanh_walk_skipping_the_steps_past_every_length_matches_the_plain_walk(reverse,
                                                                               lengths):
    """The persistent tanh-RNN walk walks t < max(lengths) only (a reverse
    chain from max(lengths) - 1, its state h0 = 0 until then) and writes
    zeros at the later steps: the same out and h_last as the plain walk over
    every step."""
    gen = torch.Generator().manual_seed(sum(lengths) + 30 * reverse)
    lens = torch.tensor(lengths, dtype=torch.int32)
    args = (torch.randn(T, B, H, generator=gen), lens, torch.randn(H, H, generator=gen) / 3)
    plan = pp.plan_rnn_tanh_f32_forward(H, B, 1, 4, SMEM)
    assert plan.blocks_per_dir > 1
    got = _tanh_walk_as_the_kernel_takes_it(*args, reverse, plan)
    want = rnn_tanh_cuda.rnn_tanh_scan_plain(*args, reverse=reverse)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def _tanh_bwd_walk_as_the_kernel_takes_it(out, dout, lengths, w_hh, reverse, plan):
    """rnn_tanh_f32_bwd_persist_kernel's walk in plain tensor ops: the carry
    through the packed rows and the exchanged, transposed and padded dpre,
    only the steps before the longest length walked (zeros after it), the
    partial carry kept per block from zero, one last pass for dh0."""
    t_max, batch, hidden = out.shape
    rows = gru_cuda.f32_rows(w_hh, plan.units, plan.blocks_per_dir, plan.padded_depth)
    dx = torch.zeros(plan.padded_depth, plan.padded_rows)
    part = torch.zeros(plan.blocks_per_dir * plan.units, plan.padded_rows)
    dpre = torch.zeros(t_max, batch, hidden)
    n = int(lengths.max())
    for s in range(n + 1):
        # each block's carry: its columns of dx^T @ rows over the whole depth
        acc = torch.cat([dx.t() @ rows[k] for k in range(plan.blocks_per_dir)], 1).t()
        dh = part + acc if s > 0 else part.clone()
        if s == n:
            return dpre, dh[:hidden, :batch].t()
        t = n - 1 - s if reverse else s
        m = (lengths > t).float()[:, None]
        d = dh[:hidden, :batch].t()
        dpre[t] = m * (d + dout[t]) * (1 - out[t] * out[t])
        part = torch.zeros_like(part)
        part[:hidden, :batch] = ((1 - m) * d).t()
        dx = torch.zeros_like(dx)
        dx[:hidden, :batch] = dpre[t].t()


@pytest.mark.parametrize("reverse", [True, False])
@pytest.mark.parametrize("lengths", [[6, 2, 0], [4, 4, 1], [0, 0, 0], [6, 6, 6]])
def test_tanh_bwd_walk_skipping_the_steps_past_every_length_matches_the_plain_walk(reverse,
                                                                                   lengths):
    """The persistent tanh-RNN backward walk walks t < max(lengths) only
    (reversed or not) and writes zeros at the later steps: there every row
    is past its length, dL/dh passes through unchanged and dpre is zero, so
    the carry into the next walked step and dh0 are those of the full walk."""
    gen = torch.Generator().manual_seed(sum(lengths) + 40 * reverse)
    lens = torch.tensor(lengths, dtype=torch.int32)
    out = torch.rand(T, B, H, generator=gen) * 2 - 1
    out[torch.arange(T)[:, None] >= lens[None, :].long()] = 0  # as the forward's
    args = (out, torch.randn(T, B, H, generator=gen), lens,
            torch.randn(H, H, generator=gen) / 3)
    plan = pp.plan_rnn_tanh_f32_backward(H, B, 1, 4, SMEM)  # several blocks of a few units
    assert plan.blocks_per_dir > 1
    got = _tanh_bwd_walk_as_the_kernel_takes_it(*args, reverse, plan)
    want = rnn_tanh_cuda.rnn_tanh_bwd_scan_plain(*args, reverse=reverse)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
