"""The host-side plan of the persistent recurrences (ops/persist_plan.py),
with an H100's figures passed in: no CUDA device is needed.

Every hidden unit is owned by exactly one block and its columns are
gate-aligned; the slice and the ring (with the partial sums over it) stay
within the shared memory a block may use; the grid stays within one block
per SM; a width that cannot fit is reported as "step".
"""

import pytest

from danspeech_tpu_torch.ops import persist_plan as pp
from danspeech_tpu_torch.ops import walks

SMS, SMEM = pp.H100_SMS, pp.H100_SMEM_OPTIN

# (hidden, batch): the flagship serving and training shapes, H=800, H=2000
# where it fits, small and odd shapes
FORWARD_FITS = [(1200, 128), (1200, 32), (1200, 8), (1200, 1), (1200, 200),
                (800, 128), (800, 32), (64, 5), (72, 1), (100, 3), (7, 2), (528, 16)]
# (hidden, batch, chains)
BACKWARD_FITS = [(1200, 32, 1), (1200, 32, 2), (1200, 8, 2), (1200, 128, 1),
                 (2000, 32, 1), (2000, 8, 1), (800, 32, 1), (800, 32, 2),
                 (72, 5, 1), (72, 5, 2), (100, 3, 1), (64, 1, 1), (7, 2, 2)]
# (hidden, batch): one GRU chain (gru_scan), the uni model's layers at the
# streaming chunk, training and serving batches, and small shapes
SCAN_FITS = [(2000, 1), (2000, 8), (2000, 9), (2000, 32), (2000, 64), (2000, 128),
             (2000, 150), (72, 5), (100, 3)]
# (hidden, batch, chains): LSTM forward chains (lstm_scan and its pair)
LSTM_FITS = [(800, 32, 1), (800, 128, 1), (800, 32, 2), (800, 128, 2), (72, 5, 2),
             (100, 3, 1), (1200, 32, 1)]
# (hidden, batch, chains): two GRU chains in one launch (gru_scan_bidi)
SCAN_PAIR_FITS = [(1200, 128, 2), (1200, 32, 2), (1200, 1, 2), (72, 5, 2), (72, 150, 2),
                  (100, 3, 2)]
# (hidden, batch, chains): LSTM backward walks (lstm_bwd_scan and its pair)
LSTM_BWD_FITS = [(800, 32, 1), (800, 32, 2), (800, 128, 2), (800, 150, 1), (800, 8, 2),
                 (72, 5, 1), (72, 5, 2), (72, 1, 2), (100, 3, 1), (72, 150, 2),
                 (1200, 32, 1)]

# (hidden, batch, chains): tanh-RNN chains and backward walks (rnn_tanh_scan,
# rnn_tanh_bwd_scan and their pairs): Tanh5x800 serving and training, small
# and odd shapes
RNN_TANH_FITS = [(800, 128, 1), (800, 128, 2), (800, 32, 1), (800, 32, 2), (100, 3, 1),
                 (100, 3, 2), (72, 150, 1), (72, 150, 2), (72, 5, 2), (72, 1, 2),
                 (1200, 128, 2), (2000, 32, 1)]


def _plans():
    for h, b in FORWARD_FITS:
        yield pytest.param(pp.plan_gru_forward(h, b, SMS, SMEM), h, b, 3, h, 2,
                           id=f"forward-H{h}-B{b}")
    for h, b, c in BACKWARD_FITS:
        yield pytest.param(pp.plan_gru_backward(h, b, c, SMS, SMEM), h, b, 1, 3 * h, c,
                           id=f"backward-H{h}-B{b}-chains{c}")
    for h, b in SCAN_FITS:
        yield pytest.param(pp.plan_gru_scan(h, b, SMS, SMEM), h, b, 3, h, 1,
                           id=f"scan-H{h}-B{b}")
    for h, b, c in LSTM_FITS:
        yield pytest.param(pp.plan_lstm_forward(h, b, c, SMS, SMEM), h, b, 4, h, c,
                           id=f"lstm-H{h}-B{b}-chains{c}")
    for h, b, c in SCAN_PAIR_FITS:
        yield pytest.param(pp.plan_gru_scan(h, b, SMS, SMEM, chains=c), h, b, 3, h, c,
                           id=f"scan-H{h}-B{b}-chains{c}")
    for h, b, c in LSTM_BWD_FITS:
        yield pytest.param(pp.plan_lstm_backward(h, b, c, SMS, SMEM), h, b, 1, 4 * h, c,
                           id=f"lstm-backward-H{h}-B{b}-chains{c}")
    for h, b, c in RNN_TANH_FITS:
        yield pytest.param(pp.plan_rnn_tanh_forward(h, b, c, SMS, SMEM), h, b, 1, h, c,
                           id=f"tanh-H{h}-B{b}-chains{c}")
        yield pytest.param(pp.plan_rnn_tanh_backward(h, b, c, SMS, SMEM), h, b, 1, h, c,
                           id=f"tanh-backward-H{h}-B{b}-chains{c}")


@pytest.mark.parametrize("plan,hidden,batch,gates,depth,directions", _plans())
def test_plan_fits_the_card(plan, hidden, batch, gates, depth, directions):
    assert plan.design == "persistent", plan.reason
    # one block per SM, all co-resident
    assert plan.grid == plan.blocks_per_dir * directions <= SMS
    # the ring first (the partial sums lie over it), then the slice, and room
    # left for the kernel's static shared memory; the CUDA-core product of a
    # small batch stages the whole left operand and its sums there instead
    assert plan.work_bytes == max(plan.ring_bytes, plan.staging_bytes, plan.dot_bytes)
    assert plan.product in ("wgmma", "dot")
    if plan.product == "dot":
        assert batch <= pp.DOT_ROWS and plan.row_groups == 1 and plan.dot_bytes % 1024 == 0
        assert plan.dot_bytes >= batch * (plan.depth_padded * 2 + (gates * plan.units + 1) * 4)
    else:
        assert plan.dot_bytes == 0
    assert plan.work_bytes % 1024 == 0 and plan.ring_bytes % 1024 == 0
    assert plan.smem_bytes == plan.work_bytes + plan.slice_bytes <= SMEM - pp.STATIC_RESERVE
    assert 2 <= plan.stages <= pp.MAX_STAGES and plan.chunk_depth in pp.KC_CHOICES
    # a chunk is read in whole boxes
    assert (plan.k_splits * plan.chunk_depth) % pp.BOX == 0
    # the two warpgroups: along the rows or along the depth, enough rows for the batch
    assert plan.row_groups in (1, 2) and plan.row_groups * plan.k_splits == pp.WARPGROUPS
    assert plan.rows_per_block == pp.GROUP_ROWS * plan.row_groups <= pp.MAX_ROWS
    assert plan.row_blocks * plan.rows_per_block >= batch
    assert (plan.row_blocks - 1) * plan.rows_per_block < batch
    assert plan.depth_padded % pp.BOX == 0 and 0 <= plan.depth_padded - depth < pp.BOX
    # the bytes are those of the layout in csrc/persist.cuh
    cols = gates * plan.units
    assert plan.slice_bytes == cols * plan.depth_padded * 2
    planes = plan.k_splits * plan.rows_per_block * (cols + 1) * 4
    assert plan.staging_bytes == -(-planes // 1024) * 1024
    stage = plan.rows_per_block * plan.k_splits * plan.chunk_depth * 2
    assert plan.ring_bytes == plan.stages * stage


@pytest.mark.parametrize("plan,hidden,batch,gates,depth,directions", _plans())
def test_every_unit_has_one_owner_and_gate_aligned_columns(
        plan, hidden, batch, gates, depth, directions):
    assert plan.units % pp.UNIT_STEP == 0
    assert (plan.blocks_per_dir - 1) * plan.units < hidden <= plan.blocks_per_dir * plan.units
    seen = []
    for block in range(plan.blocks_per_dir):
        cols = plan.columns(block, hidden, gates)
        n = len(cols) // gates
        assert 0 < n <= plan.units and len(cols) == gates * n
        units = cols[:n]
        assert all(plan.owner(j) == block for j in units)
        # gate g of unit j is column g * H + j, in the same order for each gate
        for g in range(gates):
            assert cols[g * n:(g + 1) * n] == [g * hidden + j for j in units]
        seen += cols
    assert sorted(seen) == list(range(gates * hidden))


@pytest.mark.parametrize("hidden,batch,units,grid,row_groups,stages,chunk_depth,smem", [
    (1200, 128, 24, 100, 2, 3, 64, 224256),   # flagship serving: chunks of 128 rows x 64
    (1200, 32, 24, 100, 1, 3, 64, 224256),    # flagship training, forward: 64 rows x 128
    (1200, 1, 24, 100, 1, 3, 64, 224256),     # one clip
    (800, 128, 16, 100, 2, 4, 128, 210944),   # smaller slices leave room for deeper chunks
])
def test_forward_plan_at_the_model_shapes(hidden, batch, units, grid, row_groups, stages,
                                          chunk_depth, smem):
    plan = pp.plan_gru_forward(hidden, batch, SMS, SMEM)
    assert (plan.design, plan.units, plan.grid, plan.row_groups, plan.stages,
            plan.chunk_depth, plan.smem_bytes) \
        == ("persistent", units, grid, row_groups, stages, chunk_depth, smem)


@pytest.mark.parametrize("hidden,chains,units,grid,stages,chunk_depth,slice_bytes", [
    (1200, 1, 16, 75, 3, 128, 16 * 3648 * 2),   # 117 KB slices: three stages of 32 KB
    (1200, 2, 24, 100, 3, 64, 24 * 3648 * 2),   # both chains of a layer in one launch
    # 193 KB slices leave 38 KB: four stages of 32-deep chunks
    (2000, 1, 16, 125, 4, 32, 16 * 6016 * 2),
    (800, 2, 16, 100, 4, 128, 16 * 2432 * 2),
])
def test_backward_plan_at_the_model_shapes(hidden, chains, units, grid, stages, chunk_depth,
                                           slice_bytes):
    plan = pp.plan_gru_backward(hidden, 32, chains, SMS, SMEM)
    assert (plan.design, plan.units, plan.grid, plan.stages, plan.chunk_depth,
            plan.slice_bytes) == ("persistent", units, grid, stages, chunk_depth, slice_bytes)
    assert (plan.row_groups, plan.k_splits) == (1, 2)  # B = 32: the warpgroups split the depth


@pytest.mark.parametrize("batch,product,row_blocks,smem", [
    (1, "dot", 1, 229376),      # the streaming chunk: h (4 KB) staged whole
    # the widest batch of the CUDA-core product fills the shared memory
    (8, "dot", 1, 231424),
    (32, "wgmma", 1, 229376),   # uni training: four stages of 32-deep chunks
    (64, "wgmma", 1, 229376),
    # uni serving: 128-row blocks leave one 64-deep stage beside the 192 KB
    # slice, so the batch walks two row blocks of 64
    (128, "wgmma", 2, 229376),
])
def test_scan_plan_at_the_uni_model_shapes(batch, product, row_blocks, smem):
    plan = pp.plan_gru_scan(2000, batch, SMS, SMEM)
    assert (plan.design, plan.units, plan.grid, plan.slice_bytes, plan.smem_bytes) \
        == ("persistent", 16, 125, 48 * 2048 * 2, smem)
    assert (plan.product, plan.row_groups, plan.k_splits, plan.row_blocks, plan.stages,
            plan.chunk_depth) == (product, 1, 2, row_blocks, 4, 32)


@pytest.mark.parametrize("batch,chains,units,grid,row_groups,stages,smem", [
    (32, 1, 8, 100, 1, 5, 217088),     # one chain: 52 KB slices, five 32 KB stages
    (128, 1, 8, 100, 2, 5, 217088),
    (32, 2, 16, 100, 1, 3, 204800),    # both chains of a layer: 104 KB slices
    (128, 2, 16, 100, 2, 3, 204800),
])
def test_lstm_plan_at_the_lstm5x800_shapes(batch, chains, units, grid, row_groups, stages,
                                           smem):
    plan = pp.plan_lstm_forward(800, batch, chains, SMS, SMEM)
    assert (plan.design, plan.units, plan.grid, plan.row_groups, plan.stages,
            plan.chunk_depth, plan.slice_bytes, plan.smem_bytes) \
        == ("persistent", units, grid, row_groups, stages, 128, 4 * units * 832 * 2, smem)


@pytest.mark.parametrize("batch,chains,units,grid,row_groups,stages,slice_bytes,smem", [
    (32, 1, 8, 100, 1, 5, 51200, 215040),    # one chain: 51 KB slices, five 32 KB stages
    (32, 2, 16, 100, 1, 3, 102400, 200704),  # both chains of a layer: 50 blocks a chain
    (128, 1, 8, 100, 2, 5, 51200, 215040),   # a batch above 64: row blocks of 128
    (128, 2, 16, 100, 2, 3, 102400, 200704),
    (150, 1, 8, 100, 2, 5, 51200, 215040),
    (150, 2, 16, 100, 2, 3, 102400, 200704),
])
def test_lstm_backward_plan_at_the_lstm5x800_shapes(batch, chains, units, grid, row_groups,
                                                    stages, slice_bytes, smem):
    """The walk's slice is U columns of w_hh^T 4H deep (3200 at H = 800)."""
    plan = pp.plan_lstm_backward(800, batch, chains, SMS, SMEM)
    assert (plan.design, plan.units, plan.grid, plan.blocks_per_dir, plan.row_groups,
            plan.stages, plan.chunk_depth, plan.slice_bytes, plan.smem_bytes) \
        == ("persistent", units, grid, grid // chains, row_groups, stages, 128,
            slice_bytes, smem)
    assert plan.depth_padded == 3200 and plan.slice_bytes == units * 3200 * 2


@pytest.mark.parametrize("plan_fn", [pp.plan_rnn_tanh_forward, pp.plan_rnn_tanh_backward])
@pytest.mark.parametrize("batch,chains,units,grid,row_groups,slice_bytes,smem", [
    # serving: one chain 100 blocks of 8 units (13 KB slices); both chains of
    # a layer 50 blocks a chain of 16 (26.6 KB): six 128-deep stages either way
    (128, 1, 8, 100, 2, 13312, 209920),
    (128, 2, 16, 100, 2, 26624, 223232),
    # training: the two warpgroups split the depth, chunks 256 deep
    (32, 1, 8, 100, 1, 13312, 209920),
    (32, 2, 16, 100, 1, 26624, 223232),
])
def test_rnn_tanh_plans_at_the_tanh5x800_shapes(plan_fn, batch, chains, units, grid,
                                                row_groups, slice_bytes, smem):
    """One gate, depth H = 800 (832 padded) for the chain and the walk: the
    slice is U columns of w_hh (the chain) or of w_hh^T (the walk)."""
    plan = plan_fn(800, batch, chains, SMS, SMEM)
    assert (plan.design, plan.units, plan.grid, plan.blocks_per_dir, plan.row_groups,
            plan.k_splits, plan.stages, plan.chunk_depth, plan.slice_bytes, plan.smem_bytes,
            plan.product) \
        == ("persistent", units, grid, grid // chains, row_groups, 2 // row_groups, 6, 128,
            slice_bytes, smem, "wgmma")
    assert plan.depth_padded == 832 and plan.slice_bytes == units * 832 * 2


@pytest.mark.parametrize("batch,row_groups", [(128, 2), (32, 1)])
def test_scan_pair_plan_is_the_fused_forward_plan(batch, row_groups):
    """Two gru_scan chains at H = 1200 (gru_scan_bidi) are cut as B3's
    recurrence: 24 units, 50 blocks a chain, three 64-deep stages."""
    plan = pp.plan_gru_scan(1200, batch, SMS, SMEM, chains=2)
    assert (plan.design, plan.units, plan.grid, plan.blocks_per_dir, plan.row_groups,
            plan.stages, plan.chunk_depth, plan.slice_bytes, plan.smem_bytes, plan.product) \
        == ("persistent", 24, 100, 50, row_groups, 3, 64, 175104, 224256, "wgmma")
    assert plan == pp.plan_gru_forward(1200, batch, SMS, SMEM)
    # one chain is gru_scan's own plan
    assert pp.plan_gru_scan(1200, batch, SMS, SMEM, chains=1) \
        == pp.plan_gru_scan(1200, batch, SMS, SMEM)


def test_scan_pair_at_h2000_does_not_fit_but_one_chain_does():
    """At H = 2000 a pair would need 32 units a block (a 393 KB slice):
    gru_scan_bidi then takes one launch a chain, on gru_scan's plan."""
    pair = pp.plan_gru_scan(2000, 128, SMS, SMEM, chains=2)
    assert (pair.design, pair.units, pair.slice_bytes) == ("step", 32, 393216)
    single = pp.plan_gru_scan(2000, 128, SMS, SMEM, chains=1)
    assert (single.design, single.units, single.grid) == ("persistent", 16, 125)


@pytest.mark.parametrize("plan", [
    pytest.param(pp.plan_gru_scan(2000, 128, SMS, SMEM, chains=2), id="scan-H2000-pair"),
    pytest.param(pp.plan_gru_scan(2000, 32, SMS, SMEM, chains=2), id="scan-H2000-B32-pair"),
    pytest.param(pp.plan_lstm_backward(1200, 32, 2, SMS, SMEM), id="lstm-backward-H1200-pair"),
    pytest.param(pp.plan_lstm_backward(2000, 32, 1, SMS, SMEM), id="lstm-backward-H2000"),
    pytest.param(pp.plan_gru_forward(2000, 128, SMS, SMEM), id="forward-H2000"),
    pytest.param(pp.plan_gru_forward(4096, 32, SMS, SMEM), id="forward-H4096"),
    pytest.param(pp.plan_gru_backward(2000, 32, 2, SMS, SMEM), id="backward-H2000-pair"),
    pytest.param(pp.plan_gru_backward(4000, 32, 1, SMS, SMEM), id="backward-H4000"),
    pytest.param(pp.plan_gru_backward(20000, 4, 1, SMS, SMEM), id="backward-H20000"),
    pytest.param(pp.plan_gru_forward(1200, 128, 40, SMEM), id="forward-40-SMs"),
    pytest.param(pp.plan_gru_forward(1200, 128, SMS, 100_000), id="forward-100KB"),
    pytest.param(pp.plan_gru_forward(64, 4, 1, SMEM), id="two-directions-one-SM"),
    pytest.param(pp.plan_gru_scan(6000, 8, SMS, SMEM), id="scan-H6000"),
    pytest.param(pp.plan_lstm_forward(1200, 32, 2, SMS, SMEM), id="lstm-H1200-pair"),
    pytest.param(pp.plan_lstm_forward(2000, 32, 1, SMS, SMEM), id="lstm-H2000"),
    # 40 units a block: five tiles, the tanh kernels hold four
    pytest.param(pp.plan_rnn_tanh_forward(2200, 128, 2, SMS, SMEM), id="tanh-H2200-pair"),
    pytest.param(pp.plan_rnn_tanh_backward(4300, 32, 1, SMS, SMEM), id="tanh-backward-H4300"),
])
def test_a_width_that_cannot_fit_takes_the_step_design(plan):
    assert plan.design == "step"
    assert plan.reason and plan.reason != "fits"
    assert walks.choose(None, plan) == "step"
    assert walks.choose("step", plan) == "step"
    with pytest.raises(ValueError, match="does not fit"):
        walks.choose("persistent", plan)


@pytest.mark.parametrize("batch,groups", [(1, 1), (32, 1), (64, 1), (65, 2), (128, 2),
                                           (500, 2)])
def test_row_groups_follow_the_batch(batch, groups):
    assert pp.row_groups_for(batch) == groups
    for plan in (pp.plan_gru_forward(1200, batch, SMS, SMEM),
                 pp.plan_gru_backward(1200, batch, 1, SMS, SMEM)):
        assert plan.row_groups == groups and plan.k_splits == pp.WARPGROUPS // groups
        assert plan.row_blocks == -(-batch // (64 * groups))


@pytest.mark.parametrize("design", [None, "persistent", "step"])
def test_choose_follows_the_request_where_the_plan_allows(design):
    plan = pp.plan_gru_forward(1200, 128, SMS, SMEM)
    assert walks.choose(design, plan) == (design or "persistent")


def test_choose_refuses_an_unknown_design():
    with pytest.raises(ValueError, match="unknown design"):
        walks.choose("fused", pp.plan_gru_forward(64, 4, SMS, SMEM))


@pytest.mark.parametrize("kwargs", [
    dict(hidden=0, batch=1), dict(hidden=8, batch=0), dict(hidden=8, batch=1, sm_count=0),
])
def test_plan_refuses_empty_shapes(kwargs):
    args = dict(hidden=8, batch=1, gates=3, depth=8, directions=1, sm_count=SMS,
                smem_optin=SMEM, max_tiles=18)
    args.update(kwargs)
    with pytest.raises(ValueError):
        pp.plan(**args)


class _OnCuda:
    """A CPU tensor that reports a CUDA device: it takes a wrapper's CUDA
    branch up to its launch, with no card."""

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        if name == "device":
            import torch

            return torch.device("cuda")
        return getattr(self._t, name)


# wrapper -> (its module, the Walk it hands walks.run, the chains of a call)
WRAPPERS = {
    "gru_bidi_fused": ("gru_cuda", "GRU_BIDI_FUSED", 1),
    "gru_scan": ("gru_cuda", "GRU_SCAN", 1),
    "gru_scan_bidi": ("gru_cuda", "GRU_SCAN_BIDI", 2),
    "gru_bwd_scan": ("gru_cuda", "GRU_BWD_SCAN", 1),
    "gru_bwd_scan_pair": ("gru_cuda", "GRU_BWD_SCAN", 2),
    "lstm_scan": ("lstm_cuda", "LSTM_SCAN", 1),
    "lstm_scan_with_cell": ("lstm_cuda", "LSTM_SCAN_WITH_CELL", 1),
    "lstm_scan_pair": ("lstm_cuda", "LSTM_SCAN_WITH_CELL", 2),
    "lstm_bwd_scan": ("lstm_cuda", "LSTM_BWD_SCAN", 1),
    "lstm_bwd_scan_pair": ("lstm_cuda", "LSTM_BWD_SCAN", 2),
    "rnn_tanh_scan": ("rnn_tanh_cuda", "RNN_TANH_SCAN", 1),
    "rnn_tanh_scan_pair": ("rnn_tanh_cuda", "RNN_TANH_SCAN", 2),
    "rnn_tanh_bwd_scan": ("rnn_tanh_cuda", "RNN_TANH_BWD_SCAN", 1),
    "rnn_tanh_bwd_scan_pair": ("rnn_tanh_cuda", "RNN_TANH_BWD_SCAN", 2),
}
# the wrapper whose counters a wrapper's calls grow, and the kernel's owner
# that counts its bf16 persistent launches where that is another wrapper
COUNTED_ON = {name: name.removesuffix("_pair") for name in WRAPPERS}
COUNTED_ON.update(lstm_scan_pair="lstm_scan_with_cell")
OWNER = {"gru_scan_bidi": "gru_scan", "lstm_scan_with_cell": "lstm_scan",
         "lstm_scan_pair": "lstm_scan"}
# every float32 wrapper (B1-B9): its planner
F32_PLANNER = {
    **dict.fromkeys(("gru_bidi_fused", "gru_scan", "gru_scan_bidi"), "plan_gru_f32_forward"),
    **dict.fromkeys(("gru_bwd_scan", "gru_bwd_scan_pair"), "plan_gru_f32_backward"),
    **dict.fromkeys(("lstm_scan", "lstm_scan_with_cell", "lstm_scan_pair"),
                    "plan_lstm_f32_forward"),
    **dict.fromkeys(("lstm_bwd_scan", "lstm_bwd_scan_pair"), "plan_lstm_f32_backward"),
    **dict.fromkeys(("rnn_tanh_scan", "rnn_tanh_scan_pair"), "plan_rnn_tanh_f32_forward"),
    **dict.fromkeys(("rnn_tanh_bwd_scan", "rnn_tanh_bwd_scan_pair"),
                    "plan_rnn_tanh_f32_backward"),
}
# the reverse flags each call hands its chains
REVERSES = {"gru_scan_bidi": [False, True], "gru_bwd_scan_pair": [True, False],
            "lstm_scan_pair": [False, True], "lstm_bwd_scan_pair": [True, False],
            "rnn_tanh_scan_pair": [False, True], "rnn_tanh_bwd_scan_pair": [True, False]}


def _call(name, hidden, batch, dtype="float32"):
    """A call of wrapper ``name`` on operands of the set ``dtype`` that report
    CUDA (T = 2, allocated and never read), taking ``design``."""
    import torch

    from danspeech_tpu_torch.ops import gru_cuda, lstm_cuda, rnn_tanh_cuda

    t, h = 2, hidden
    seq = getattr(torch, dtype)

    def e(*shape):  # a sequence or a weight
        return _OnCuda(torch.empty(*shape, dtype=seq))

    def f(*shape):  # a bias, a state or a cotangent: f32 in either set
        return _OnCuda(torch.empty(*shape))

    lens = _OnCuda(torch.full((batch,), t, dtype=torch.int32))
    gru_chain = (e(t, batch, 3 * h), lens, e(h, 3 * h), f(3 * h), f(3 * h), f(batch, h))
    gru_walk = (e(t, batch, 3 * h), e(t, batch, h), f(t, batch, h), lens, e(h, 3 * h),
                f(3 * h), f(3 * h), f(batch, h))
    lstm_chain = (e(t, batch, 4 * h), lens, e(h, 4 * h), f(4 * h), f(batch, h), f(batch, h))
    lstm_walk = (e(t, batch, 4 * h), e(t, batch, h), e(t, batch, h), f(t, batch, h), lens,
                 e(h, 4 * h), f(4 * h))
    tanh_chain = (e(t, batch, h), lens, e(h, h))
    tanh_walk = (e(t, batch, h), f(t, batch, h), lens, e(h, h))
    fused = (e(t, batch, 16), lens, e(16, 3 * h), e(16, 3 * h), e(h, 3 * h), e(h, 3 * h),
             f(3 * h), f(3 * h), f(3 * h), f(3 * h))
    bidi = (gru_chain[0], e(t, batch, 3 * h), lens, gru_chain[2], e(h, 3 * h),
            *gru_chain[3:5], f(3 * h), f(3 * h), gru_chain[5], f(batch, h))
    return {
        "gru_bidi_fused": lambda d: gru_cuda.gru_bidi_fused(*fused, design=d),
        "gru_scan": lambda d: gru_cuda.gru_scan(*gru_chain, design=d),
        "gru_scan_bidi": lambda d: gru_cuda.gru_scan_bidi(*bidi, design=d),
        "gru_bwd_scan": lambda d: gru_cuda.gru_bwd_scan(*gru_walk, design=d),
        "gru_bwd_scan_pair": lambda d: gru_cuda.gru_bwd_scan_pair(
            gru_walk, gru_walk, True, False, design=d),
        "lstm_scan": lambda d: lstm_cuda.lstm_scan(*lstm_chain, design=d),
        "lstm_scan_with_cell": lambda d: lstm_cuda.lstm_scan_with_cell(*lstm_chain, design=d),
        "lstm_scan_pair": lambda d: lstm_cuda.lstm_scan_pair(
            lstm_chain, lstm_chain, False, True, with_cell=True, design=d),
        "lstm_bwd_scan": lambda d: lstm_cuda.lstm_bwd_scan(*lstm_walk, design=d),
        "lstm_bwd_scan_pair": lambda d: lstm_cuda.lstm_bwd_scan_pair(
            lstm_walk, lstm_walk, True, False, design=d),
        "rnn_tanh_scan": lambda d: rnn_tanh_cuda.rnn_tanh_scan(*tanh_chain, design=d),
        "rnn_tanh_scan_pair": lambda d: rnn_tanh_cuda.rnn_tanh_scan_pair(
            tanh_chain, tanh_chain, False, True, design=d),
        "rnn_tanh_bwd_scan": lambda d: rnn_tanh_cuda.rnn_tanh_bwd_scan(*tanh_walk, design=d),
        "rnn_tanh_bwd_scan_pair": lambda d: rnn_tanh_cuda.rnn_tanh_bwd_scan_pair(
            tanh_walk, tanh_walk, True, False, design=d),
    }[name]


def _fake_launchers(monkeypatch, name, sms):
    """Replace the four launchers of wrapper ``name``'s Walk by recorders, the
    card by one of ``sms`` SMs and every counter by zeros; returns the list
    of (launcher, chains, reverses, plan) they record."""
    import dataclasses
    import importlib

    from danspeech_tpu_torch.ops import walks

    module_name, walk_name, _ = WRAPPERS[name]
    module = importlib.import_module(f"danspeech_tpu_torch.ops.{module_name}")
    routed = []

    def fake(kind):
        def launch(chains, reverses, planned=None):
            routed.append((kind, list(chains), list(reverses), planned))
            return [(None, None)] * len(chains)
        return launch

    walk = getattr(module, walk_name)
    monkeypatch.setattr(module, walk_name, dataclasses.replace(
        walk, **{k: fake(k) for k in ("persistent", "step", "persistent_f32", "step_f32")}))
    monkeypatch.setattr(walks, "device_info", lambda device: (sms, SMEM))
    for wrapper in _counters().values():
        for attr, zero in (("launches", 0), ("chains", 0),
                           ("design_counts", {"persistent": 0, "step": 0}),
                           ("dtype_counts", {"bfloat16": 0, "float32": 0})):
            monkeypatch.setattr(wrapper, attr, zero)
    return routed


def _counters():
    from danspeech_tpu_torch.ops import gru_cuda, lstm_cuda, rnn_tanh_cuda

    return {name: getattr(m, name) for m in (gru_cuda, lstm_cuda, rnn_tanh_cuda)
            for name in set(COUNTED_ON.values()) if hasattr(m, name)}


def _read(wrapper):
    return (wrapper.launches, wrapper.chains, dict(wrapper.design_counts),
            dict(wrapper.dtype_counts))


@pytest.mark.parametrize("sms", [SMS, 1])
@pytest.mark.parametrize("design", [None, "persistent", "step"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_run_counts_exactly_the_launches_it_issues(monkeypatch, name, dtype, design, sms):
    """Every wrapper, in both operand sets and every design, on a card where
    every plan fits (an H100's figures, H = 16) and on one of one SM, where
    no two chains fit in one launch: its counter rises by exactly the C calls
    walks.run issued (one for a cooperative launch of two chains or a step
    design's host loop), ``chains`` by the chains walked, no other counter
    moves. A pair walks both chains in one persistent launch where the
    two-chain plan fits, else one launch a chain on the one-chain plan; the
    bf16 step kernels take one chain (B2's two), the float32 ones two. B2's
    bf16 persistent launches count on gru_scan, B6's on lstm_scan. Where no
    plan fits (B3's two directions on one SM) None takes the step design and
    "persistent" raises before anything is launched or counted."""
    routed = _fake_launchers(monkeypatch, name, sms)
    chains = WRAPPERS[name][2]
    counters = _counters()
    f32 = dtype == "float32"
    if sms == 1 and name == "gru_bidi_fused" and design == "persistent":
        with pytest.raises(ValueError, match="does not fit: 2 .* on 1 SMs"):
            _call(name, 16, 5, dtype)(design)
        assert routed == [] and all(w.launches == 0 for w in counters.values())
        return
    _call(name, 16, 5, dtype)(design)
    taken = "step" if design == "step" or (sms == 1 and name == "gru_bidi_fused") \
        else "persistent"
    if taken == "persistent":
        launches = chains if sms == 1 else 1
    else:
        launches = 1 if f32 or name == "gru_scan_bidi" else chains
    kind = taken + ("_f32" if f32 else "")
    assert [r[0] for r in routed] == [kind] * launches
    assert sum(len(r[1]) for r in routed) == chains
    assert [f for r in routed for f in r[2]] == REVERSES.get(name, [True] * chains
                                                           if "bwd" in name else [False])
    if taken == "persistent":
        planner = getattr(pp, F32_PLANNER[name]) if f32 else None
        for r in routed:
            assert r[3].design == "persistent"
            if planner is not None and name != "gru_bidi_fused":
                assert r[3] == planner(16, 5, len(r[1]), sms, SMEM)
    counted = COUNTED_ON[name]
    if taken == "persistent" and not f32:
        counted = OWNER.get(name, counted)
    for wrapper_name, wrapper in counters.items():
        want = (0, 0, {"persistent": 0, "step": 0}, {"bfloat16": 0, "float32": 0})
        if wrapper_name == counted:
            want = (launches, chains, {"persistent": 0, "step": 0, taken: launches},
                    {"bfloat16": 0, "float32": 0, dtype: launches})
        assert _read(wrapper) == want, wrapper_name


@pytest.mark.parametrize("hidden,batch", [(1200, 128), (1200, 32), (2000, 1), (2000, 128),
                                          (64, 5), (8, 1)])
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_float32_plans_take_the_step_design_everywhere(monkeypatch, name, hidden, batch):
    """B1-B9 in float32 are planned (plan_gru_f32_forward for B1-B3,
    plan_gru_f32_backward for B4, plan_lstm_f32_forward for B5 and B6,
    plan_lstm_f32_backward for B7, plan_rnn_tanh_f32_forward for B8,
    plan_rnn_tanh_f32_backward for B9, an H100's figures), and every plan
    fits at these shapes: None and "persistent" take the persistent launcher
    with the plan of all the call's chains (B3's two directions, a pair's
    two chains), "step" the step launcher, one launch either way, counted by
    its design. An unknown design raises ValueError, before anything is
    launched or counted."""
    routed = _fake_launchers(monkeypatch, name, SMS)
    wrapper = _counters()[COUNTED_ON[name]]
    planner = getattr(pp, F32_PLANNER[name])
    chains = 2 if name == "gru_bidi_fused" else WRAPPERS[name][2]
    call = _call(name, hidden, batch)
    designs = (None, "step", "persistent")
    for k, design in enumerate(designs, 1):
        call(design)
        assert len(routed) == k
        taken = "persistent" if design != "step" else "step"
        assert routed[-1][0] == taken + "_f32"
        if taken == "persistent":
            assert routed[-1][3] == planner(hidden, batch, chains, SMS, SMEM)
            assert routed[-1][3].design == "persistent"
    assert _read(wrapper) == (3, 3 * WRAPPERS[name][2], {"persistent": 2, "step": 1},
                              {"bfloat16": 0, "float32": 3})
    with pytest.raises(ValueError, match="unknown design"):
        call("fused")
    assert len(routed) == len(designs) and wrapper.launches == len(designs)


@pytest.mark.parametrize("name", list(F32_PLANNER))
def test_f32_walk_of_names_each_wrappers_walk(name):
    """persist_plan.F32_WALK_OF, which chip_smoke.py plans each float32
    walk by, names for every wrapper the walk its planner plans, at a
    training and a serving layer shape."""
    planner = getattr(pp, F32_PLANNER[name])
    assert set(pp.F32_WALK_OF) == set(F32_PLANNER)
    for hidden, batch in ((800, 32), (800, 128)):
        for chains in (1, 2):
            got = pp.plan_f32(pp.F32_WALK_OF[name], hidden, batch, chains, SMS, SMEM)
            assert got == planner(hidden, batch, chains, SMS, SMEM)
            assert got.walk == pp.F32_WALK_OF[name]


@pytest.mark.parametrize("name", ["gru_bidi_fused", "gru_scan", "gru_scan_bidi"])
def test_float32_forward_takes_the_step_design_where_the_plan_does(monkeypatch, name):
    """On a card of one SM two chains cannot run persistently: B3 and B2's
    pair plan "step". B3 then takes the step launcher for None and refuses
    "persistent" (ValueError naming the reason) before anything runs; B2
    walks its chains one launch each on the one-chain plan, which fits, and
    counts two launches; B1 has one chain and stays persistent."""
    routed = _fake_launchers(monkeypatch, name, 1)
    wrapper = _counters()[name]
    call = _call(name, 64, 5)
    call(None)
    single = pp.plan_gru_f32_forward(64, 5, 1, 1, SMEM)
    assert single.design == "persistent" and single.grid == 1
    assert pp.plan_gru_f32_forward(64, 5, 2, 1, SMEM).design == "step"
    if name == "gru_bidi_fused":
        assert [r[0] for r in routed] == ["step_f32"]
        with pytest.raises(ValueError, match="does not fit: 2 chains on 1 SMs"):
            call("persistent")
        assert wrapper.design_counts == {"persistent": 0, "step": 1}
    elif name == "gru_scan_bidi":
        assert [r[0] for r in routed] == ["persistent_f32"] * 2
        assert [len(r[1]) for r in routed] == [1, 1]
        assert [r[2] for r in routed] == [[False], [True]]
        assert all(r[3] == single for r in routed)
        assert wrapper.design_counts == {"persistent": 2, "step": 0}
    else:
        assert [r[0] for r in routed] == ["persistent_f32"]
        assert routed[0][3] == single
        assert wrapper.design_counts == {"persistent": 1, "step": 0}


@pytest.mark.parametrize("name", ["gru_bwd_scan_pair", "lstm_scan_pair", "gru_bwd_scan",
                                  "lstm_scan", "lstm_bwd_scan_pair", "lstm_bwd_scan",
                                  "rnn_tanh_scan_pair", "rnn_tanh_scan",
                                  "rnn_tanh_bwd_scan_pair", "rnn_tanh_bwd_scan"])
def test_float32_walk_pairs_take_a_launch_a_chain_where_the_pair_does_not_fit(monkeypatch,
                                                                             name):
    """On a card of one SM the float32 pair plans of B4, B5/B6, B7, B8 and
    B9 are "step" (two chains on one SM) and the one-chain plans fit: a pair
    then walks its chains in one persistent launch each, on the one-chain
    plan, and counts two launches; "persistent" is allowed (the one-chain
    plan fits) and "step" walks both chains in one step launch. A single
    chain stays persistent."""
    routed = _fake_launchers(monkeypatch, name, 1)
    chains = WRAPPERS[name][2]
    wrapper = _counters()[COUNTED_ON[name]]
    planner = getattr(pp, F32_PLANNER[name])
    call = _call(name, 64, 5)
    single = planner(64, 5, 1, 1, SMEM)
    assert single.design == "persistent" and single.grid == 1
    assert planner(64, 5, 2, 1, SMEM).design == "step"
    call(None)
    call("persistent")
    assert len(routed) == 2 * chains
    assert all(r[0] == "persistent_f32" and len(r[1]) == 1 and r[3] == single
               for r in routed)
    if chains == 2:
        assert [r[2] for r in routed[:2]] == [[f] for f in REVERSES[name]]
    call("step")
    assert routed[-1][0] == "step_f32" and len(routed[-1][1]) == chains
    assert wrapper.design_counts == {"persistent": 2 * chains, "step": 1}
    assert (wrapper.launches, wrapper.chains) == (2 * chains + 1, 3 * chains)


def test_bidi_fused_reads_kept_weight_layouts(monkeypatch):
    """B3's persistent launch reads w_hh^T of both directions from
    gru_cuda.transposed and the stacked w_ih^T from
    gru_cuda.stacked_transposes, kept per tensor: the same tensors come back
    on the second call, and are made again after a weight is written in
    place (an optimizer step)."""
    import torch

    from danspeech_tpu_torch.ops import cuda_build, gru_cuda

    calls = []
    monkeypatch.setattr(cuda_build, "bind", lambda *a: a)
    monkeypatch.setattr(cuda_build, "call", lambda fn, name, dev, *args: calls.append(args))
    gen = torch.Generator().manual_seed(5)
    t, b, d, h = 3, 2, 16, 8

    def w(*shape):
        return torch.randn(*shape, generator=gen).to(torch.bfloat16)

    layer = (w(t, b, d), torch.tensor([3, 2], dtype=torch.int32), w(d, 3 * h), w(d, 3 * h),
             w(h, 3 * h), w(h, 3 * h), *(torch.randn(3 * h, generator=gen) for _ in range(4)))
    planned = pp.plan_gru_forward(h, b, SMS, SMEM)
    kept = gru_cuda.stacked_transposes(layer[2], layer[3])
    assert torch.equal(kept, torch.stack([layer[2].t(), layer[3].t()]))
    for _ in range(2):
        gru_cuda._bidi_fused(*layer, planned=planned)
    assert gru_cuda.stacked_transposes(layer[2], layer[3]) is kept
    for args in calls:
        assert args[4] == gru_cuda.transposed(layer[4]).data_ptr()
        assert args[5] == gru_cuda.transposed(layer[5]).data_ptr()
        assert args[15] == kept.data_ptr()
    layer[3].add_(0)  # a new version: the stacked copy is made again
    again = gru_cuda.stacked_transposes(layer[2], layer[3])
    assert again is not kept and torch.equal(again, kept)
    gru_cuda._bidi_fused(*layer, planned=planned)
    assert calls[-1][15] == again.data_ptr()
    w_hh_t = gru_cuda.transposed(layer[4])
    layer[4].add_(0)
    assert gru_cuda.transposed(layer[4]) is not w_hh_t


def test_wrappers_take_a_design_argument_and_use_the_plain_version_on_the_cpu():
    """On CPU tensors the wrappers run the plain versions whatever the
    design; the design counters only count CUDA calls."""
    import torch

    from danspeech_tpu_torch.ops import gru_cuda

    gen = torch.Generator().manual_seed(0)
    t, b, h = 3, 2, 8
    gx = torch.randn(t, b, 3 * h, generator=gen)
    hprev = torch.randn(t, b, h, generator=gen)
    dout = torch.randn(t, b, h, generator=gen)
    lens = torch.tensor([3, 2], dtype=torch.int32)
    w = torch.randn(h, 3 * h, generator=gen) * 0.3
    bi, bh = torch.randn(3 * h, generator=gen), torch.randn(3 * h, generator=gen)
    dh = torch.randn(b, h, generator=gen)
    ops = (gx, hprev, dout, lens, w, bi, bh, dh)
    before = dict(gru_cuda.gru_bwd_scan.design_counts)
    want = gru_cuda.gru_bwd_scan_plain(*ops, reverse=True)
    for design in (None, "persistent", "step"):
        got = gru_cuda.gru_bwd_scan(*ops, reverse=True, design=design)
        for g, r in zip(got, want):
            assert torch.equal(g, r)
    pair_a, pair_b = gru_cuda.gru_bwd_scan_pair(ops, ops, True, False)
    for g, r in zip(pair_a, want):
        assert torch.equal(g, r)
    for g, r in zip(pair_b, gru_cuda.gru_bwd_scan_plain(*ops, reverse=False)):
        assert torch.equal(g, r)
    assert gru_cuda.gru_bwd_scan.design_counts == before


@pytest.mark.parametrize("design", [None, "persistent", "step"])
def test_forward_wrappers_take_a_design_argument_and_use_the_plain_version_on_the_cpu(
        design):
    """gru_scan, lstm_scan, lstm_scan_with_cell and lstm_scan_pair on CPU
    tensors run the plain versions whatever the design, and count nothing."""
    import torch

    from danspeech_tpu_torch.ops import gru_cuda, lstm_cuda

    gen = torch.Generator().manual_seed(1)
    t, b, h = 4, 3, 8
    lens = torch.tensor([4, 0, 2], dtype=torch.int32)
    h0, c0 = torch.randn(b, h, generator=gen), torch.randn(b, h, generator=gen)
    gx3 = torch.randn(t, b, 3 * h, generator=gen)
    w3 = torch.randn(h, 3 * h, generator=gen) * 0.3
    bi, bh = torch.randn(3 * h, generator=gen), torch.randn(3 * h, generator=gen)
    wrappers = (gru_cuda.gru_scan, lstm_cuda.lstm_scan, lstm_cuda.lstm_scan_with_cell)
    before = [(w.launches, dict(w.design_counts)) for w in wrappers]
    got = gru_cuda.gru_scan(gx3, lens, w3, bi, bh, h0, reverse=True, design=design)
    for g, r in zip(got, gru_cuda.gru_scan_plain(gx3, lens, w3, bi, bh, h0, reverse=True)):
        assert torch.equal(g, r)
    chains = [(torch.randn(t, b, 4 * h, generator=gen), lens,
               torch.randn(h, 4 * h, generator=gen) * 0.3, torch.randn(4 * h, generator=gen),
               h0, c0) for _ in range(2)]
    for with_cell, plain in ((False, lstm_cuda.lstm_scan_plain),
                             (True, lstm_cuda.lstm_scan_with_cell_plain)):
        single = lstm_cuda.lstm_scan_with_cell if with_cell else lstm_cuda.lstm_scan
        for g, r in zip(single(*chains[0], reverse=False, design=design),
                        plain(*chains[0], reverse=False)):
            assert torch.equal(g, r)
        pair = lstm_cuda.lstm_scan_pair(chains[0], chains[1], False, True,
                                        with_cell=with_cell, design=design)
        for got_chain, chain, reverse in zip(pair, chains, (False, True)):
            for g, r in zip(got_chain, plain(*chain, reverse=reverse)):
                assert torch.equal(g, r)
    assert [(w.launches, dict(w.design_counts)) for w in wrappers] == before


@pytest.mark.parametrize("design", [None, "persistent", "step"])
def test_slice_7_wrappers_take_a_design_argument_and_use_the_plain_version_on_the_cpu(
        design):
    """lstm_bwd_scan, lstm_bwd_scan_pair and gru_scan_bidi on CPU tensors run
    the plain versions whatever the design, and count nothing."""
    import torch

    from danspeech_tpu_torch.ops import gru_cuda, lstm_cuda

    gen = torch.Generator().manual_seed(2)
    t, b, h = 5, 3, 8
    lens = torch.tensor([5, 0, 3], dtype=torch.int32)

    def walk():
        return (torch.randn(t, b, 4 * h, generator=gen), torch.randn(t, b, h, generator=gen),
                torch.randn(t, b, h, generator=gen), torch.randn(t, b, h, generator=gen), lens,
                torch.randn(h, 4 * h, generator=gen) * 0.3, torch.randn(4 * h, generator=gen))

    wrappers = (lstm_cuda.lstm_bwd_scan, gru_cuda.gru_scan_bidi)
    before = [(w.launches, dict(w.design_counts)) for w in wrappers]
    chains = lstm_cuda.lstm_bwd_scan.chains
    a, c = walk(), walk()
    for g, r in zip(lstm_cuda.lstm_bwd_scan(*a, reverse=True, design=design),
                    lstm_cuda.lstm_bwd_scan_plain(*a, reverse=True)):
        assert torch.equal(g, r)
    got = lstm_cuda.lstm_bwd_scan_pair(a, c, True, False, design=design)
    for got_chain, chain, reverse in zip(got, (a, c), (True, False)):
        for g, r in zip(got_chain, lstm_cuda.lstm_bwd_scan_plain(*chain, reverse=reverse)):
            assert torch.equal(g, r)
    bidi = [torch.randn(t, b, 3 * h, generator=gen) for _ in range(2)] + [lens]
    bidi += [torch.randn(h, 3 * h, generator=gen) * 0.3 for _ in range(2)]
    bidi += [torch.randn(3 * h, generator=gen) for _ in range(4)]
    bidi += [torch.randn(b, h, generator=gen) for _ in range(2)]
    for g, r in zip(gru_cuda.gru_scan_bidi(*bidi, design=design),
                    gru_cuda.gru_scan_bidi_plain(*bidi)):
        assert torch.equal(g, r)
    assert [(w.launches, dict(w.design_counts)) for w in wrappers] == before
    assert lstm_cuda.lstm_bwd_scan.chains == chains
