"""The plan of the persistent float32 GRU forward walk
(ops/persist_plan.py:plan_gru_f32_forward) with an H100's figures passed in,
and the packed weight slices it reads (ops/gru_cuda.py:f32_slices): no CUDA
device is needed.

Every unit of every chain is owned by exactly one block; the grid stays
within one block per SM; the work area, the staged h and the resident share
of the slice stay within the shared memory a block may use, laid out as
csrc/gru_f32.cu lays them out; a shape that cannot fit is reported as
"step" with a reason.
"""

import pytest
import torch

from danspeech_tpu_torch.ops import gru_cuda, walks
from danspeech_tpu_torch.ops import persist_plan as pp

SMS, SMEM = pp.H100_SMS, pp.H100_SMEM_OPTIN

# (hidden, batch, chains): GPUStreamingRNN's layers (B1) at the streaming
# chunk, both sides of the small-B switch, the cohorts of 64 and 65, the uni
# batch; the flagship's layers (B2, B3) at serving and training batches and
# one clip; B2 at H = 2000; small and ragged shapes
FITS = [(2000, 1, 1), (2000, 2, 1), (2000, 8, 1), (2000, 9, 1), (2000, 63, 1),
        (2000, 64, 1), (2000, 65, 1), (2000, 128, 1), (2000, 150, 1),
        (1200, 128, 2), (1200, 32, 2), (1200, 1, 2), (1200, 128, 1), (2000, 32, 2),
        (2000, 128, 2), (800, 128, 2), (72, 5, 1), (72, 5, 2), (100, 3, 1), (100, 3, 2),
        (72, 150, 1), (72, 150, 2), (64, 5, 2), (7, 2, 2), (8, 1, 1), (1, 1, 1)]


def _id(shape):
    return "H{}-B{}-chains{}".format(*shape)


def _work_floats(plan):
    """fp_work_floats of csrc/gru_f32.cu: the ring, or the partial sums and
    the state's tile over it, in floats rounded up to 4."""
    cols = 3 * plan.units
    rows_in_ring = 0 if plan.product == "dot" else plan.rows_per_pass
    ring = plan.stages * plan.chunk_depth * (rows_in_ring + cols)
    sums = plan.k_splits * plan.rows_per_pass * cols + plan.units * plan.rows_per_pass
    return -(-max(ring, sums) // 4) * 4


@pytest.mark.parametrize("hidden,batch,chains", FITS, ids=[_id(s) for s in FITS])
def test_f32_plan_fits_the_card(hidden, batch, chains):
    plan = pp.plan_gru_f32_forward(hidden, batch, chains, SMS, SMEM)
    assert plan.design == "persistent" and plan.reason == "fits"
    assert plan.chains == chains
    # one block per SM, all co-resident
    assert plan.grid == plan.blocks_per_dir * chains <= SMS
    # the product: no padding rows below the switch, passes of at most 128 rows above
    assert plan.product == ("dot" if batch <= pp.F32_DOT_ROWS else "tiled")
    if plan.product == "dot":
        assert plan.rows_per_pass == plan.padded_rows == batch and plan.passes == 1
        assert plan.h_bytes == 4 * (-(-plan.padded_depth * batch // 4) * 4)
        work = 3 * plan.units
    else:
        assert plan.rows_per_pass % pp.F32_TILE_ROWS == 0
        assert plan.rows_per_pass <= pp.F32_PASS_ROWS
        assert plan.padded_rows == plan.passes * plan.rows_per_pass >= batch
        assert (plan.passes - 1) * plan.rows_per_pass < batch
        assert plan.h_bytes == 0
        work = (plan.rows_per_pass // 8) * (plan.units // 2)
    # the threads: the product's work times the depth splits, whole warps
    assert plan.k_splits in (1, 2, 4, 8) and plan.chunk_depth % plan.k_splits == 0
    assert work * plan.k_splits <= plan.threads <= pp.F32_MAX_THREADS
    assert plan.threads % 32 == 0 and plan.threads - work * plan.k_splits < 32
    assert plan.k_splits == pp.F32_MAX_SPLITS or 2 * work * plan.k_splits > pp.F32_MAX_THREADS
    # the depth in whole chunks; the resident share from depth 0, whole chunks
    assert plan.chunk_depth == pp.F32_CHUNK[plan.product]
    assert plan.stages == pp.F32_STAGES
    assert plan.padded_depth % plan.chunk_depth == 0
    assert 0 <= plan.padded_depth - hidden < plan.chunk_depth
    assert plan.resident_depth % plan.chunk_depth == 0
    assert 0 <= plan.resident_depth <= plan.padded_depth
    assert plan.resident_share == plan.resident_depth / plan.padded_depth
    # shared memory: the work area, the staged h ("dot"), the resident slice
    cols = 3 * plan.units
    assert plan.slice_bytes == plan.padded_depth * cols * 4
    assert plan.smem_bytes == 4 * _work_floats(plan) + plan.h_bytes \
        + 4 * plan.resident_depth * cols
    assert plan.smem_bytes <= SMEM - pp.STATIC_RESERVE
    # a whole chunk more of the slice would not have fit
    if plan.resident_depth < plan.padded_depth:
        assert plan.smem_bytes + 4 * plan.chunk_depth * cols > SMEM - pp.STATIC_RESERVE
    assert plan.c_args() == (
        plan.units, plan.blocks_per_dir, plan.rows_per_pass, plan.padded_rows,
        plan.padded_depth, plan.k_splits, plan.chunk_depth, plan.resident_depth, plan.threads,
        plan.smem_bytes, int(plan.product == "dot"))


@pytest.mark.parametrize("hidden,batch,chains", FITS, ids=[_id(s) for s in FITS])
def test_every_unit_of_every_chain_has_one_owner(hidden, batch, chains):
    plan = pp.plan_gru_f32_forward(hidden, batch, chains, SMS, SMEM)
    assert plan.units % pp.F32_TILE_UNITS == 0
    assert (plan.blocks_per_dir - 1) * plan.units < hidden <= plan.blocks_per_dir * plan.units
    owners = {}
    for block in range(plan.grid):  # chain c's blocks are c * blocks .. (c + 1) * blocks - 1
        chain, k = divmod(block, plan.blocks_per_dir)
        for j in range(k * plan.units, min((k + 1) * plan.units, hidden)):
            assert plan.owner(j) == k
            assert (chain, j) not in owners
            owners[(chain, j)] = block
    assert sorted(owners) == [(c, j) for c in range(chains) for j in range(hidden)]


@pytest.mark.parametrize(
    "hidden,batch,chains,product,units,grid,threads,k_splits,rows,resident,smem", [
        # the streaming chunk: one column a thread, eight depth splits, 44% resident
        (2000, 1, 1, "dot", 16, 125, 384, 8, 1, 896, 229376),
        # the widest small-B batch: its staged h (64 KB) leaves a quarter resident
        (2000, 8, 1, "dot", 16, 125, 384, 8, 8, 512, 212992),
        # just past the switch: one pass of 16 rows
        (2000, 9, 1, "tiled", 16, 125, 128, 8, 16, 1024, 229376),
        (2000, 64, 1, "tiled", 16, 125, 256, 4, 64, 896, 229376),
        (2000, 65, 1, "tiled", 16, 125, 288, 4, 72, 832, 221184),
        # the uni batch: 128 rows a pass, two depth splits
        (2000, 128, 1, "tiled", 16, 125, 256, 2, 128, 704, 225280),
        # B3 and B2 at the flagship: 20 units a block, 60 blocks a chain
        (1200, 128, 2, "tiled", 20, 120, 320, 2, 128, 512, 219136),
        (1200, 32, 2, "tiled", 20, 120, 320, 8, 32, 640, 217600),
        (2000, 32, 2, "tiled", 32, 126, 256, 4, 32, 384, 212992),
    ])
def test_f32_plan_at_the_path_shapes(hidden, batch, chains, product, units, grid, threads,
                                     k_splits, rows, resident, smem):
    plan = pp.plan_gru_f32_forward(hidden, batch, chains, SMS, SMEM)
    assert (plan.design, plan.product, plan.units, plan.grid, plan.threads, plan.k_splits,
            plan.rows_per_pass, plan.resident_depth, plan.smem_bytes) \
        == ("persistent", product, units, grid, threads, k_splits, rows, resident, smem)


@pytest.mark.parametrize("args,reason", [
    ((1200, 128, 2, 1, SMEM), "2 chains on 1 SMs"),
    # the ring of 64-deep chunks of 128 rows alone exceeds 48 KB
    ((2000, 128, 1, SMS, 48 * 1024), "ring and sums"),
    # 122 units a block: 976 threads of tiles
    ((8000, 128, 2, SMS, SMEM), "976 threads"),
    # the dot product stages the whole of h: 8 x 9088 floats
    ((9000, 8, 1, SMS, SMEM), "h 290816 B"),
])
def test_f32_plan_takes_the_step_design_where_it_cannot_fit(args, reason):
    plan = pp.plan_gru_f32_forward(*args)
    assert plan.design == "step" and reason in plan.reason
    assert walks.choose(None, plan) == "step" and walks.choose("step", plan) == "step"
    with pytest.raises(ValueError, match="does not fit"):
        walks.choose("persistent", plan)


@pytest.mark.parametrize("args", [(0, 1, 1), (8, 0, 1), (8, 1, 0), (8, 1, 3)])
def test_f32_plan_refuses_bad_shapes(args):
    with pytest.raises(ValueError):
        pp.plan_gru_f32_forward(*args, SMS, SMEM)


@pytest.mark.parametrize("hidden,units,blocks,depth", [(7, 2, 4, 64), (72, 2, 36, 128),
                                                       (100, 20, 5, 128), (64, 16, 4, 64)])
def test_f32_slices_pack_each_blocks_columns_depth_major(hidden, units, blocks, depth):
    """Block k's column g * units + u at depth d is w_hh[d, g * H + k * units
    + u]; zeros for units past H and depths past H."""
    gen = torch.Generator().manual_seed(hidden)
    w = torch.randn(hidden, 3 * hidden, generator=gen)
    packed = gru_cuda.f32_slices(w, units, blocks, depth)
    assert packed.shape == (blocks, depth, 3 * units) and packed.is_contiguous()
    want = torch.zeros(blocks, depth, 3 * units)
    for k in range(blocks):
        for g in range(3):
            for u in range(units):
                j = k * units + u
                if j < hidden:
                    want[k, :hidden, g * units + u] = w[:, g * hidden + j]
    assert torch.equal(packed, want)


def test_f32_slices_are_kept_per_tensor_and_remade_after_a_write():
    w = torch.randn(8, 24)
    packed = gru_cuda.f32_slices(w, 2, 4, 64)
    assert gru_cuda.f32_slices(w, 2, 4, 64) is packed
    # another cut of the same tensor is another entry
    other = gru_cuda.f32_slices(w, 4, 2, 64)
    assert other.shape == (2, 64, 12) and gru_cuda.f32_slices(w, 2, 4, 64) is packed
    with torch.no_grad():
        w.mul_(2.0)  # an optimizer step: a new version
    again = gru_cuda.f32_slices(w, 2, 4, 64)
    assert again is not packed and torch.equal(again, 2.0 * packed)
    key = (id(w), 2, 4, 64)
    assert key in gru_cuda._f32_slices
    del w, packed, again, other
    assert key not in gru_cuda._f32_slices
    with torch.inference_mode():
        frozen = torch.randn(8, 24)
    assert gru_cuda.f32_slices(frozen, 2, 4, 64) is not gru_cuda.f32_slices(frozen, 2, 4, 64)


# ---------------------------------------------------------------------------
# What the persistent routes hand their C entries (CPU tensors, no launch)
# ---------------------------------------------------------------------------


def _c_signature(fn_name):
    """(pointer parameters, int parameters) of ``extern "C" int fn_name(...)``
    in csrc/gru_f32.cu, the trailing stream left out; pointers come first."""
    import re

    from danspeech_tpu_torch.ops import cuda_build

    with open(f"{cuda_build.CSRC_DIR}/gru_f32.cu") as f:
        text = re.sub(r"//[^\n]*", "", f.read())
    m = re.search(r'extern "C" int ' + fn_name + r"\((.*?)\)\s*\{", text, re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    assert params[-1] == "void* stream"
    kinds = ["ptr" if "*" in p else "int" for p in params[:-1]]
    assert kinds == sorted(kinds, key=lambda k: k != "ptr"), "pointers first, then ints"
    return kinds.count("ptr"), kinds.count("int")


def _record_launch(monkeypatch, state_shape):
    """Stands in for cuda_build.bind and .call; returns the record: the bound
    entry, the arguments, and a copy of the exchanged state (the pointer
    after the biases) as the entry would read it."""
    import ctypes

    import numpy as np

    from danspeech_tpu_torch.ops import cuda_build

    rec = {}

    def call(fn, name, dev, *args):
        rec["args"] = args
        ptr = ctypes.cast(args[9 if fn[1] == "gru_f32_persist_launch" else 11],
                          ctypes.POINTER(ctypes.c_float))
        rec["state"] = np.ctypeslib.as_array(ptr, shape=state_shape).copy()

    monkeypatch.setattr(cuda_build, "bind", lambda *a: rec.setdefault("bound", a))
    monkeypatch.setattr(cuda_build, "call", call)
    return rec


@pytest.mark.parametrize("constant,define", [
    ("F32_STAGES", "FP_STAGES"), ("F32_DOT_ROWS", "FP_DOT_ROWS"),
    ("F32_MAX_THREADS", "FP_MAX_THREADS")])
def test_plan_constants_mirror_the_kernel(constant, define):
    """The plan sizes shared memory, the small-B switch and the threads of a
    block with the numbers the kernel is compiled with: gru_f32.cu's own and
    those of the walks' shared header it includes."""
    import re

    from danspeech_tpu_torch.ops import cuda_build

    text = ""
    for name in ("gru_f32.cu", "f32_walk.cuh"):
        with open(f"{cuda_build.CSRC_DIR}/{name}") as f:
            text += f.read()
    assert '#include "f32_walk.cuh"' in text
    found = re.findall(rf"^#define {define} (\d+)", text, re.M)
    assert len(found) == 1 and int(found[0]) == getattr(pp, constant)


T, B, H, D = 6, 3, 16, 10


@pytest.mark.parametrize("chains,reverses", [(1, [False]), (1, [True]), (2, [False, True])])
def test_persistent_scan_route_matches_its_c_entry(monkeypatch, chains, reverses):
    """B1 and B2, persistent: the entry gets each chain's gx, lengths, packed
    slices and biases (one chain fills both), the state with each chain's h0
    transposed in buffer 0 and zeros elsewhere, and (T, B, H, reverse_a,
    reverse_b, chains) then the plan's ints."""
    plan = pp.plan_gru_f32_forward(H, B, chains, SMS, SMEM)
    rec = _record_launch(monkeypatch, (2, chains, plan.padded_depth, plan.padded_rows))
    lengths = torch.tensor([6, 2, 0], dtype=torch.int32)
    ops = [(torch.randn(T, B, 3 * H), lengths, torch.randn(H, 3 * H), torch.randn(3 * H),
            torch.randn(3 * H), torch.randn(B, H)) for _ in range(chains)]
    outs = gru_cuda._scan_f32_persistent(ops, reverses, plan)
    source, fn_name, n_ptr, n_int = rec["bound"]
    assert (source, fn_name) == ("gru_f32", "gru_f32_persist_launch")
    assert (n_ptr, n_int) == _c_signature(fn_name) == (15, 17)
    args = rec["args"]
    assert len(args) == n_ptr + n_int
    assert list(args[n_ptr:]) == [T, B, H, int(reverses[0]), int(reverses[-1]), chains,
                                  *plan.c_args()]
    slices = [gru_cuda.f32_slices(c[2], plan.units, plan.blocks_per_dir, plan.padded_depth)
              for c in ops]
    last = ops[-1]
    assert list(args[:9]) == [ops[0][0].data_ptr(), last[0].data_ptr(), lengths.data_ptr(),
                              slices[0].data_ptr(), slices[-1].data_ptr(),
                              ops[0][3].data_ptr(), last[3].data_ptr(),
                              ops[0][4].data_ptr(), last[4].data_ptr()]
    want = torch.zeros(2, chains, plan.padded_depth, plan.padded_rows)
    for k, c in enumerate(ops):
        want[0, k, :H, :B] = c[5].t()
    assert torch.equal(torch.from_numpy(rec["state"]), want)
    assert args[10:14] == (outs[0][1].data_ptr(), outs[-1][1].data_ptr(),
                           outs[0][0].data_ptr(), outs[-1][0].data_ptr())
    assert [(tuple(o.shape), tuple(h.shape)) for o, h in outs] == [((T, B, H), (B, H))] * chains


def test_persistent_bidi_fused_route_matches_its_c_entry(monkeypatch):
    """B3, persistent: x, lengths, w_ih of both directions, the packed
    slices, the biases, the gx buffer, a zeroed state (h0 = 0), h_last and
    out, then (T, B, D, H) and the plan's ints."""
    plan = pp.plan_gru_f32_forward(H, B, 2, SMS, SMEM)
    rec = _record_launch(monkeypatch, (2, 2, plan.padded_depth, plan.padded_rows))
    x = torch.randn(T, B, D)
    lengths = torch.tensor([6, 2, 0], dtype=torch.int32)
    w = (torch.randn(D, 3 * H), torch.randn(D, 3 * H), torch.randn(H, 3 * H),
         torch.randn(H, 3 * H), *(torch.randn(3 * H) for _ in range(4)))
    out_f, out_b, hl_f, hl_b = gru_cuda._bidi_fused_f32_persistent(x, lengths, *w,
                                                                    planned=plan)
    source, fn_name, n_ptr, n_int = rec["bound"]
    assert (source, fn_name) == ("gru_f32", "gru_f32_bidi_fused_persist_launch")
    assert (n_ptr, n_int) == _c_signature(fn_name) == (15, 15)
    args = rec["args"]
    assert list(args[n_ptr:]) == [T, B, D, H, *plan.c_args()]
    slices = [gru_cuda.f32_slices(m, plan.units, plan.blocks_per_dir, plan.padded_depth)
              for m in w[2:4]]
    assert list(args[:10]) == [x.data_ptr(), lengths.data_ptr(), w[0].data_ptr(),
                               w[1].data_ptr(), slices[0].data_ptr(), slices[1].data_ptr(),
                               *(b.data_ptr() for b in w[4:])]
    assert not rec["state"].any()
    assert {tuple(o.shape) for o in (out_f, out_b)} == {(T, B, H)}
    assert {tuple(h.shape) for h in (hl_f, hl_b)} == {(B, H)}
    assert args[12] == hl_f.data_ptr() and args[13] == out_f.data_ptr()
