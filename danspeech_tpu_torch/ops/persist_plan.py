"""The host-side plan of a persistent recurrence (``csrc/persist.cuh``).

A persistent kernel walks every step of a recurrence in one cooperative
launch: each block keeps a gate-aligned slice of the recurrent weights in
shared memory for the whole walk and streams the step's left operand through
a ring beside it. Whether a shape can run that way, and how it is cut over
the card, is decided here, before any launch, from the shape and two
properties of the device (its SM count and the shared memory one block may
use). :func:`plan` is a pure function: the tests call it with an H100's
figures (:data:`H100_SMS`, :data:`H100_SMEM_OPTIN`) and no device.

The rule: one block per SM. Take the smallest number of units per block, a
multiple of 8 (the step of a wgmma's width), whose blocks (ceil(H / units) per
direction, times the directions) are no more than the SMs; the shape runs
persistently if that slice, a ring beside it and the kernel's template range
hold it, else it takes the ``"step"`` design (one launch per time step). The
ring takes what the slice leaves free, up to six stages. A chunk costs the
copy engine a fixed time whatever its size, so chunks are as deep as leaves
three stages: 128 per warpgroup, else 64, else (where the two warpgroups
split the depth: a chunk is read in boxes 64 deep) 32, of which two must fit. The
partial sums of a product lie over the ring. A batch above 64 rows takes row
blocks of 128 (a warpgroup each 64 rows); where their chunks leave too few
stages beside the slice (one GRU chain at H = 2000), it walks row blocks of
64 instead, the two warpgroups splitting the depth. Fewer units per block
would need more blocks than can be co-resident; more would only use fewer SMs.

These plans are those of the bf16 operand set: the resident design keeps
bf16 slices. The float32 GRU walks (B1, B2 and B3's recurrence, and the
backward walk B4, in ``csrc/gru_f32.cu``), the float32 LSTM walks (B5, B6
and the backward walk B7, ``csrc/lstm_f32.cu``) and the float32 tanh-RNN
walks (B8 and the backward walk B9, ``csrc/rnn_tanh_f32.cu``) have a
persistent design of their own (``csrc/f32_walk.cuh``), planned by
:func:`plan_f32` (:func:`plan_gru_f32_forward`,
:func:`plan_gru_f32_backward`, :func:`plan_lstm_f32_forward`,
:func:`plan_lstm_f32_backward`, :func:`plan_rnn_tanh_f32_forward`,
:func:`plan_rnn_tanh_f32_backward`): float32 weights do not fit the card's
shared memory at these widths, so a block keeps what fits of its slice
resident and streams the rest from L2 each step.

The constants mirror ``csrc/persist.cuh``.
"""

from __future__ import annotations

import dataclasses

THREADS = 256       # PS_THREADS: the 8 multiplying warps (a block has one more)
WARPGROUPS = 2      # of 4 warps each; a warpgroup multiplies 64 rows at a time
GROUP_ROWS = 64
KC_CHOICES = (128, 64, 32)  # depth one warpgroup covers of a ring chunk, by preference
MAX_STAGES = 6      # PS_MAX_STAGES
BOX = 64            # PS_BOX: depth of one swizzled tile of the operand and the slice
UNIT_STEP = 8       # units per block come in tiles of 8 columns
MAX_ROWS = 128      # rows of the left operand per row block (2 warpgroups)
STATIC_RESERVE = 1024  # bytes kept free for a kernel's static shared memory
DOT_ROWS = 8        # PS_DOT_ROWS: the widest batch of the CUDA-core product

# R_BR of csrc/rnn_step.cuh: the batch rows a block of the LSTM and tanh-RNN
# step kernels owns; the step design's grid holds ceil(B / STEP_ROWS) of them
STEP_ROWS = 64

H100_SMS = 132
H100_SMEM_OPTIN = 232_448

DESIGNS = ("persistent", "step")


@dataclasses.dataclass(frozen=True)
class PersistPlan:
    """How one recurrence is cut over the card. ``design`` is "persistent"
    or "step"; for "step" the sizes describe the candidate that did not fit
    (zeros if there was none) and ``reason`` says why."""

    design: str
    reason: str
    units: int = 0            # hidden units per block
    blocks_per_dir: int = 0
    grid: int = 0             # blocks_per_dir * directions
    row_groups: int = 0       # warpgroups along the rows of a row block: 1 or 2
    k_splits: int = 0         # depth slices per chunk: 2 / row_groups
    rows_per_block: int = 0   # row_groups * 64
    row_blocks: int = 0       # ceil(batch / rows_per_block)
    depth_padded: int = 0     # depth rounded up to 64
    stages: int = 0           # ring stages: 2 .. MAX_STAGES
    chunk_depth: int = 0      # depth one warpgroup covers of a ring chunk: 128, 64 or 32
    slice_bytes: int = 0      # the resident weight slice
    ring_bytes: int = 0       # stages * one chunk of the left operand
    staging_bytes: int = 0    # the partial sums (they lie over the ring)
    work_bytes: int = 0       # the larger of ring and partial sums: the slice's offset
    smem_bytes: int = 0       # work + slice: dynamic shared memory per block
    product: str = "wgmma"    # "wgmma" (the ring), or "dot": the CUDA cores
    dot_bytes: int = 0        # "dot": the staged left operand and the sums after it

    def owner(self, unit: int) -> int:
        """The block (within its direction) that owns hidden unit ``unit``."""
        return unit // self.units

    def columns(self, block: int, hidden: int, gates: int) -> list[int]:
        """The columns of the (depth, gates * hidden) matrix that block
        ``block`` keeps resident, in shared-memory row order."""
        j0 = block * self.units
        return [g * hidden + j for g in range(gates)
                for j in range(j0, min(j0 + self.units, hidden))]


def row_groups_for(batch: int) -> int:
    """Warpgroups along the rows: one (the two split the depth) for a batch
    of up to 64 rows, two (row blocks of 128) above."""
    return 1 if batch <= GROUP_ROWS else 2


def plan(hidden: int, batch: int, gates: int, depth: int, directions: int,
         sm_count: int, smem_optin: int, max_tiles: int) -> PersistPlan:
    """The plan of one recurrence.

    ``hidden`` units, each owning ``gates`` columns of a weight matrix that is
    ``depth`` deep (forward GRU: 3 gates, depth H; forward LSTM: 4 gates,
    depth H; the GRU's backward walk: 1 column, depth 3H); ``batch`` rows in
    the left operand; ``directions`` chains in the launch; ``max_tiles`` the
    widest slice, in tiles of 8 columns, that the kernel is compiled for.
    """
    if min(hidden, batch, gates, depth, directions, sm_count) < 1:
        raise ValueError("hidden, batch, gates, depth, directions and sm_count "
                         "must be positive")
    per_dir = sm_count // directions
    if per_dir < 1:
        return PersistPlan("step", f"{directions} directions on {sm_count} SMs")
    first = _plan_rows(hidden, batch, gates, depth, directions, smem_optin, max_tiles,
                       per_dir, row_groups_for(batch))
    if first.design == "step" and first.row_groups == 2:
        halves = _plan_rows(hidden, batch, gates, depth, directions, smem_optin,
                            max_tiles, per_dir, 1)
        if halves.design == "persistent":
            return halves
    return first


def _plan_rows(hidden, batch, gates, depth, directions, smem_optin, max_tiles, per_dir,
               row_groups) -> PersistPlan:
    """:func:`plan` with the warpgroups along the rows given."""
    units = -(-hidden // per_dir)                  # ceil(H / blocks allowed)
    units = -(-units // UNIT_STEP) * UNIT_STEP     # up to a multiple of 8
    blocks = -(-hidden // units)
    cols = gates * units
    k_splits = WARPGROUPS // row_groups
    rows = row_groups * GROUP_ROWS
    depth_padded = -(-depth // BOX) * BOX
    slice_bytes = cols * depth_padded * 2
    staging_bytes = k_splits * rows * (cols + 1) * 4  # a plane per depth split
    sizes = dict(
        units=units, blocks_per_dir=blocks, grid=blocks * directions,
        row_groups=row_groups, k_splits=k_splits, rows_per_block=rows,
        row_blocks=-(-batch // rows), depth_padded=depth_padded,
        slice_bytes=slice_bytes, staging_bytes=staging_bytes,
    )
    if cols // UNIT_STEP > max_tiles:
        return PersistPlan(
            "step", f"{units} units x {gates} gates = {cols // UNIT_STEP} tiles, "
            f"the kernel holds {max_tiles}", **sizes)
    budget = smem_optin - STATIC_RESERVE - slice_bytes
    # the slice starts on 1024 bytes: its swizzle counts rows from there
    staging_bytes = -(-staging_bytes // 1024) * 1024
    sizes["staging_bytes"] = staging_bytes
    stage_bytes = 0
    for kc in KC_CHOICES:
        least = 2 if kc == KC_CHOICES[-1] else 3  # stages a chunk depth must leave room for
        if (k_splits * kc) % BOX:
            continue
        if kc != KC_CHOICES[-1] and k_splits * kc >= 2 * depth_padded:
            continue  # a chunk twice as deep as the whole product is mostly zeros
        stage_bytes = rows * k_splits * kc * 2
        stages = min(MAX_STAGES, budget // stage_bytes)
        work = max(stages * stage_bytes, staging_bytes)
        if stages >= least and work <= budget:
            return PersistPlan(
                "persistent", "fits", stages=stages, chunk_depth=kc,
                ring_bytes=stages * stage_bytes, work_bytes=work,
                smem_bytes=work + slice_bytes, **sizes)
    work = max(2 * stage_bytes, staging_bytes)
    return PersistPlan(
        "step", f"slice {slice_bytes} B + ring and partial sums {work} B of "
        f"{smem_optin - STATIC_RESERVE} B a block", stages=2,
        chunk_depth=KC_CHOICES[-1], ring_bytes=2 * stage_bytes, work_bytes=work,
        smem_bytes=slice_bytes + work, **sizes)


# the widest slices the kernels are compiled for (the switch statements of the
# host entries), in MMA tiles of 8 columns
GRU_FWD_MAX_TILES = 18   # csrc/gru_bidi_fused.cu, csrc/gru_scan.cu: 3 gates x up to 48 units
GRU_BWD_MAX_TILES = 8    # csrc/gru_bwd.cu: up to 64 units
LSTM_FWD_MAX_TILES = 8   # csrc/lstm_scan.cu: 4 gates x 8 or 16 units
LSTM_BWD_MAX_TILES = 3   # csrc/lstm_bwd.cu: up to 24 units
RNN_TANH_FWD_MAX_TILES = 4  # csrc/rnn_tanh_scan.cu: up to 32 units
RNN_TANH_BWD_MAX_TILES = 4  # csrc/rnn_tanh_bwd.cu: up to 32 units


def plan_gru_forward(hidden, batch, sm_count, smem_optin) -> PersistPlan:
    """Both chains of a bidirectional GRU layer (``gru_bidi_fused``): per
    direction h (B, H) @ w_hh (H, 3H)."""
    return plan(hidden, batch, 3, hidden, 2, sm_count, smem_optin,
                GRU_FWD_MAX_TILES)


def plan_gru_scan(hidden, batch, sm_count, smem_optin, chains=1) -> PersistPlan:
    """``chains`` (1 or 2) GRU chains over precomputed projections in one
    launch (``gru_scan``; ``gru_scan_bidi``, both directions of a layer): per
    chain h (B, H) @ w_hh (H, 3H). A batch of at most :data:`DOT_ROWS` rows
    (the streaming chunk) takes the product on the CUDA cores where its
    staged operand fits beside the slice: the whole of h in shared memory,
    the sums after it (``ps_dot_product`` in ``csrc/persist.cuh``)."""
    planned = plan(hidden, batch, 3, hidden, chains, sm_count, smem_optin,
                   GRU_FWD_MAX_TILES)
    if planned.design != "persistent" or batch > DOT_ROWS:
        return planned
    dot = batch * planned.depth_padded * 2 + batch * (3 * planned.units + 1) * 4
    dot = -(-dot // 1024) * 1024
    work = max(planned.work_bytes, dot)
    if work + planned.slice_bytes > smem_optin - STATIC_RESERVE:
        return planned
    return dataclasses.replace(planned, product="dot", dot_bytes=dot, work_bytes=work,
                               smem_bytes=work + planned.slice_bytes)


def plan_lstm_forward(hidden, batch, chains, sm_count, smem_optin) -> PersistPlan:
    """``chains`` (1 or 2) LSTM chains in one launch (``lstm_scan``,
    ``lstm_scan_with_cell`` and their pair): per chain h (B, H) @ w_hh
    (H, 4H)."""
    return plan(hidden, batch, 4, hidden, chains, sm_count, smem_optin,
                LSTM_FWD_MAX_TILES)


def plan_gru_backward(hidden, batch, chains, sm_count, smem_optin) -> PersistPlan:
    """The backward walk of ``chains`` (1 or 2) GRU chains (``gru_bwd_scan``):
    per chain dgh (B, 3H) @ w_hh^T (3H, H)."""
    return plan(hidden, batch, 1, 3 * hidden, chains, sm_count, smem_optin,
                GRU_BWD_MAX_TILES)


def plan_lstm_backward(hidden, batch, chains, sm_count, smem_optin) -> PersistPlan:
    """The backward walk of ``chains`` (1 or 2) LSTM chains
    (``lstm_bwd_scan`` and its pair): per chain dg (B, 4H) @ w_hh^T (4H, H)."""
    return plan(hidden, batch, 1, 4 * hidden, chains, sm_count, smem_optin,
                LSTM_BWD_MAX_TILES)


def plan_rnn_tanh_forward(hidden, batch, chains, sm_count, smem_optin) -> PersistPlan:
    """``chains`` (1 or 2) tanh-RNN chains in one launch (``rnn_tanh_scan``
    and its pair): per chain h (B, H) @ w_hh (H, H)."""
    return plan(hidden, batch, 1, hidden, chains, sm_count, smem_optin,
                RNN_TANH_FWD_MAX_TILES)


def plan_rnn_tanh_backward(hidden, batch, chains, sm_count, smem_optin) -> PersistPlan:
    """The backward walk of ``chains`` (1 or 2) tanh-RNN chains
    (``rnn_tanh_bwd_scan`` and its pair): per chain dpre (B, H) @ w_hh^T
    (H, H)."""
    return plan(hidden, batch, 1, hidden, chains, sm_count, smem_optin,
                RNN_TANH_BWD_MAX_TILES)


# The persistent float32 walks (csrc/f32_walk.cuh, and the kernels of
# csrc/gru_f32.cu, csrc/lstm_f32.cu and csrc/rnn_tanh_f32.cu that use it); the
# constants mirror its FP_* ones.
F32_DOT_ROWS = 8         # FP_DOT_ROWS: the widest batch of the small-B product
F32_MAX_THREADS = 384    # FP_MAX_THREADS: a block's threads (168 registers each)
F32_TILE_ROWS = 8        # rows of a thread's tile in the tiled product
F32_TILE_UNITS = 2       # units of a thread's tile, a column a gate each
F32_PASS_ROWS = 128      # the most rows of one pass of the tiled product
F32_MAX_SPLITS = 8       # depth splits of a product, summed in their order
# depth of one chunk of the ring, by product: a chunk costs a wait and a
# block-wide barrier, so deep chunks (on an H100, 64 against 32 for the tiled
# product and 128 against 64 for the small-B one were the faster: PERF.md)
F32_CHUNK = {"tiled": 64, "dot": 128}
F32_STAGES = 2           # FP_STAGES: two stages leave the most of the slice resident

# The walks, by name: (gate columns a unit owns, the product's depth in units
# of H, whether the small-B product is compiled, the tile the epilogue keeps
# over the partial sums in units of U x rows a pass, the state the block
# keeps beside the work area for the whole walk in units of U x padded rows)
F32_WALKS = {
    # gru_f32_persist_kernel: h @ w_hh (H, 3H); the new state's tile Hn
    "gru_forward": (3, 1, True, 1, 0),
    # gru_f32_bwd_persist_kernel: dgh @ w_hh^T (3H, H); the new dgh's tile Dn
    # (three gates); the partial carry P
    "gru_backward": (1, 3, False, 3, 1),
    # lstm_f32_persist_kernel: h @ w_hh (H, 4H); the tile Hn; the cell state
    "lstm_forward": (4, 1, False, 1, 1),
    # lstm_f32_bwd_persist_kernel: dg4 @ w_hh^T (4H, H); the new dg4's tile Dn
    # (four gates); the partial carry P and the cell gradient DC
    "lstm_backward": (1, 4, False, 4, 2),
    # rnn_tanh_f32_persist_kernel: h @ w_hh (H, H); the tile Hn; no state
    "rnn_tanh_forward": (1, 1, False, 1, 0),
    # rnn_tanh_f32_bwd_persist_kernel: dpre @ w_hh^T (H, H); the new dpre's
    # tile Dn; the partial carry P
    "rnn_tanh_backward": (1, 1, False, 1, 1),
}
# the walk each float32 wrapper launches (B1-B9)
F32_WALK_OF = {
    **dict.fromkeys(("gru_scan", "gru_scan_bidi", "gru_bidi_fused"), "gru_forward"),
    **dict.fromkeys(("gru_bwd_scan", "gru_bwd_scan_pair"), "gru_backward"),
    **dict.fromkeys(("lstm_scan", "lstm_scan_with_cell", "lstm_scan_pair"), "lstm_forward"),
    **dict.fromkeys(("lstm_bwd_scan", "lstm_bwd_scan_pair"), "lstm_backward"),
    **dict.fromkeys(("rnn_tanh_scan", "rnn_tanh_scan_pair"), "rnn_tanh_forward"),
    **dict.fromkeys(("rnn_tanh_bwd_scan", "rnn_tanh_bwd_scan_pair"), "rnn_tanh_backward"),
}


@dataclasses.dataclass(frozen=True)
class F32Plan:
    """How a persistent float32 walk (:data:`F32_WALKS`) of ``chains``
    chains is cut over the card. ``design`` is "persistent" or "step"; for
    "step" the sizes describe the candidate that did not fit (zeros if there
    was none) and ``reason`` says why. ``product`` is "dot" (the small-B
    product of the GRU forward walk, at most :data:`F32_DOT_ROWS` rows) or
    "tiled" (8 rows x 2 units x the walk's gate columns of sums a thread)."""

    design: str
    reason: str
    product: str = ""
    chains: int = 0
    units: int = 0            # hidden units per block, even
    blocks_per_dir: int = 0
    grid: int = 0             # blocks_per_dir * chains: at most the SM count
    threads: int = 0          # a multiple of 32
    k_splits: int = 0         # depth splits of the product
    rows_per_pass: int = 0    # rows of the left operand one pass multiplies
    passes: int = 0
    padded_rows: int = 0      # the row stride of the exchanged operand: passes * rows
    chunk_depth: int = 0
    padded_depth: int = 0     # the product's depth rounded up to the chunk depth
    stages: int = 0
    resident_depth: int = 0   # depths of the slice kept in shared memory
    slice_bytes: int = 0      # a block's whole slice: padded_depth x columns x 4
    ring_bytes: int = 0
    sums_bytes: int = 0       # the partial sums and the epilogue's tile (over the ring)
    h_bytes: int = 0          # "dot": the whole of h, staged once a step
    smem_bytes: int = 0
    walk: str = ""            # a key of F32_WALKS
    state_bytes: int = 0      # what the block keeps for the whole walk (c, the carry)

    @property
    def resident_share(self) -> float:
        """The share of each block's slice that stays in shared memory."""
        return self.resident_depth / self.padded_depth if self.padded_depth else 0.0

    def owner(self, unit: int) -> int:
        """The block (within its chain) that owns hidden unit ``unit``."""
        return unit // self.units

    def c_args(self) -> tuple[int, ...]:
        """The plan's ints in the order the walks' C entries take them
        (``gru_f32_persist_launch``, ``gru_f32_bwd_persist_launch``,
        ``lstm_f32_persist_launch``, ``lstm_f32_bwd_persist_launch``,
        ``rnn_tanh_f32_persist_launch``, ``rnn_tanh_f32_bwd_persist_launch``)."""
        return (self.units, self.blocks_per_dir, self.rows_per_pass, self.padded_rows,
                self.padded_depth, self.k_splits, self.chunk_depth, self.resident_depth,
                self.threads, self.smem_bytes, int(self.product == "dot"))


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def plan_f32(walk, hidden, batch, chains, sm_count, smem_optin) -> F32Plan:
    """The persistent float32 walk ``walk`` (a key of :data:`F32_WALKS`) of
    ``chains`` (1 or 2) chains, float32 throughout.

    One block per SM: the units of all chains are cut into blocks of an even
    number of units, as few per block as keep the grid within the SMs; a
    block owns the walk's gate columns of its units over the product's depth.
    Up to :data:`F32_DOT_ROWS` rows take the small-B product where the walk
    has one (no padding rows; a thread owns one gate column and a share of
    the depth), more (or any, where it has none) the tiled one (passes of at
    most 128 rows, 8 rows x 2 units x the gate columns of sums a thread).
    The depth is split over as many slices as keep the block within
    :data:`F32_MAX_THREADS` threads. Shared memory holds the ring (the chunks
    of the left operand and of the streamed weights), the partial sums and
    the epilogue's tile over it, the whole of h for the small-B product, the
    state the walk keeps (the LSTM's c, the backward walks' carries), and then
    as much of the block's slice, from depth 0, as fits: the resident depth.
    The rest of the slice streams from L2 through the ring each step. "step"
    where the block would need more threads than that or the rest alone does
    not fit.
    """
    if walk not in F32_WALKS:
        raise ValueError(f"unknown walk {walk!r}: one of {tuple(F32_WALKS)}")
    gates, depth_of, has_dot, tile_of, state_of = F32_WALKS[walk]
    if min(hidden, batch, chains, sm_count) < 1:
        raise ValueError("hidden, batch, chains and sm_count must be positive")
    if chains > 2:
        raise ValueError(f"one or two chains, not {chains}")
    per_dir = sm_count // chains
    if per_dir < 1:
        return F32Plan("step", f"{chains} chains on {sm_count} SMs", walk=walk)
    units = _up(max(1, -(-hidden // per_dir)), F32_TILE_UNITS)
    blocks = -(-hidden // units)
    cols = gates * units
    product = "dot" if has_dot and batch <= F32_DOT_ROWS else "tiled"
    kc, stages = F32_CHUNK[product], F32_STAGES
    depth = _up(depth_of * hidden, kc)
    if product == "dot":
        passes, rows, padded = 1, batch, batch
        work = cols                                   # a thread a column and split
        h_floats, stage = _up(depth * batch, 4), kc * cols
    else:
        passes = -(-batch // F32_PASS_ROWS)
        rows = _up(-(-batch // passes), F32_TILE_ROWS)
        padded = passes * rows
        work = (rows // F32_TILE_ROWS) * (units // F32_TILE_UNITS)  # a thread a tile and split
        h_floats, stage = 0, kc * (rows + cols)
    state = _up(state_of * units * padded, 4)
    sizes = dict(product=product, chains=chains, units=units, blocks_per_dir=blocks,
                 grid=blocks * chains, rows_per_pass=rows, passes=passes, padded_rows=padded,
                 chunk_depth=kc, padded_depth=depth, stages=stages,
                 slice_bytes=depth * cols * 4, h_bytes=h_floats * 4, walk=walk,
                 state_bytes=state * 4)
    if work > F32_MAX_THREADS:
        return F32Plan("step", f"{work} threads a block for {units} units x {rows} rows, "
                       f"the kernel takes {F32_MAX_THREADS}", **sizes)
    splits = 1
    while splits < F32_MAX_SPLITS and 2 * splits * work <= F32_MAX_THREADS:
        splits *= 2
    ring = stages * stage
    sums = splits * rows * cols + tile_of * units * rows
    work_floats = _up(max(ring, sums), 4)
    budget = (smem_optin - STATIC_RESERVE) // 4 - work_floats - h_floats - state
    sizes.update(threads=_up(splits * work, 32), k_splits=splits, ring_bytes=ring * 4,
                 sums_bytes=sums * 4)
    if budget < 0:
        kept = f" + state {state * 4} B" if state else ""
        return F32Plan("step", f"ring and sums {work_floats * 4} B + h {h_floats * 4} B"
                       f"{kept} of {smem_optin - STATIC_RESERVE} B a block", **sizes,
                       smem_bytes=4 * (work_floats + h_floats + state))
    resident = min(depth, budget // (cols * kc) * kc)
    return F32Plan("persistent", "fits", resident_depth=resident,
                   smem_bytes=4 * (work_floats + h_floats + state + resident * cols), **sizes)


def plan_gru_f32_forward(hidden, batch, chains, sm_count, smem_optin) -> F32Plan:
    """The persistent float32 GRU forward walk (B1, B2, B3's recurrence) of
    ``chains`` (1 or 2) chains of h (B, H) @ w_hh (H, 3H): :func:`plan_f32`."""
    return plan_f32("gru_forward", hidden, batch, chains, sm_count, smem_optin)


def plan_gru_f32_backward(hidden, batch, chains, sm_count, smem_optin) -> F32Plan:
    """The persistent float32 GRU backward walk (B4) of ``chains`` (1 or 2)
    chains: per chain the carry dgh (B, 3H) @ w_hh^T (3H, H), a column a unit
    (the rows of w_hh) over a depth of 3H, and the partial carry kept in the
    block: :func:`plan_f32`."""
    return plan_f32("gru_backward", hidden, batch, chains, sm_count, smem_optin)


def plan_lstm_f32_forward(hidden, batch, chains, sm_count, smem_optin) -> F32Plan:
    """The persistent float32 LSTM forward walk (B5, B6) of ``chains`` (1 or
    2) chains of h (B, H) @ w_hh (H, 4H), the cell state kept in the block:
    :func:`plan_f32`."""
    return plan_f32("lstm_forward", hidden, batch, chains, sm_count, smem_optin)


def plan_lstm_f32_backward(hidden, batch, chains, sm_count, smem_optin) -> F32Plan:
    """The persistent float32 LSTM backward walk (B7) of ``chains`` (1 or 2)
    chains: per chain the carry dg4 (B, 4H) @ w_hh^T (4H, H), a column a unit
    (the rows of w_hh) over a depth of 4H, the partial carry and the cell
    gradient kept in the block: :func:`plan_f32`."""
    return plan_f32("lstm_backward", hidden, batch, chains, sm_count, smem_optin)


def plan_rnn_tanh_f32_forward(hidden, batch, chains, sm_count, smem_optin) -> F32Plan:
    """The persistent float32 tanh-RNN forward walk (B8) of ``chains`` (1 or
    2) chains of h (B, H) @ w_hh (H, H), a column a unit, no state kept in
    the block: :func:`plan_f32`."""
    return plan_f32("rnn_tanh_forward", hidden, batch, chains, sm_count, smem_optin)


def plan_rnn_tanh_f32_backward(hidden, batch, chains, sm_count, smem_optin) -> F32Plan:
    """The persistent float32 tanh-RNN backward walk (B9) of ``chains`` (1 or
    2) chains: per chain the carry dpre (B, H) @ w_hh^T (H, H), a column a
    unit (the rows of w_hh) over a depth of H, the partial carry kept in the
    block: :func:`plan_f32`."""
    return plan_f32("rnn_tanh_backward", hidden, batch, chains, sm_count, smem_optin)

