"""GRU layer and the GRU kernel module of the PyTorch port against the JAX
package (CPU).

The kernel itself runs only on the card (chip_smoke.py checks it against
its plain version there). Here its plain version, which the wrapper runs
for CPU tensors, is held against ``gru_scan_bidi_fused(interpret=True)``:
with bf16 operands and f32 accumulation on both sides, the bf16 outputs may
differ by BF16_OUT_ATOL (two bf16 ulps at |h| < 1) and the f32 h_last by
H_LAST_ATOL, from summation order. Float32 layers against the JAX lax.scan
path: F32_ATOL.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from danspeech_tpu.ops import rnn as jrnn
from danspeech_tpu.ops.pallas_gru import gru_scan_bidi_fused
from danspeech_tpu_torch.ops import cuda_build, gru_cuda
from danspeech_tpu_torch.ops import rnn as trnn

BF16_OUT_ATOL = 8e-3
H_LAST_ATOL = 1e-4
F32_ATOL = 1e-5
SPLIT_H_LAST_ATOL = 1e-7  # one f32 ulp at |h| < 1


def _weights(rng, d_in, hidden, scale=0.3):
    arrays = [
        rng.uniform(-scale, scale, (d_in, 3 * hidden)),
        rng.uniform(-scale, scale, (hidden, 3 * hidden)),
        rng.uniform(-scale, scale, 3 * hidden),
        rng.uniform(-scale, scale, 3 * hidden),
    ]
    return [a.astype(np.float32) for a in arrays]


def _jax_w(arrays, dtype=jnp.float32):
    w_ih, w_hh, b_ih, b_hh = arrays
    return jrnn.GRUWeights(jnp.asarray(w_ih, dtype), jnp.asarray(w_hh, dtype),
                           jnp.asarray(b_ih), jnp.asarray(b_hh))


def _torch_w(arrays, dtype=torch.float32):
    w_ih, w_hh, b_ih, b_hh = arrays
    return trnn.GRUWeights(torch.from_numpy(w_ih).to(dtype),
                           torch.from_numpy(w_hh).to(dtype),
                           torch.from_numpy(b_ih), torch.from_numpy(b_hh))


@pytest.mark.parametrize(
    "t,lengths,d_in,hidden",
    [
        (13, [13, 1, 7, 12], 24, 16),
        (19, [19, 11, 6, 2, 19], 40, 32),  # T and H not multiples of any tile
        (1, [1, 1], 8, 8),
    ],
)
def test_plain_fused_matches_pallas_interpret_bf16(t, lengths, d_in, hidden):
    rng = np.random.default_rng(t)
    x = rng.normal(size=(t, len(lengths), d_in)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    f, b = _weights(rng, d_in, hidden), _weights(rng, d_in, hidden)
    jf, jb = _jax_w(f, jnp.bfloat16), _jax_w(b, jnp.bfloat16)
    h0 = jnp.zeros((len(lengths), hidden), jnp.float32)
    ref = gru_scan_bidi_fused(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(lens),
        jf.w_ih, jb.w_ih, jf.w_hh, jb.w_hh, jf.b_ih, jb.b_ih, jf.b_hh, jb.b_hh,
        h0, h0, interpret=True,
    )
    tf, tb = _torch_w(f, torch.bfloat16), _torch_w(b, torch.bfloat16)
    before = gru_cuda.gru_bidi_fused.launches
    got = gru_cuda.gru_bidi_fused(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(lens),
        tf.w_ih, tb.w_ih, tf.w_hh, tb.w_hh, tf.b_ih, tb.b_ih, tf.b_hh, tb.b_hh,
    )
    # a CPU tensor runs the plain version: no kernel launch is counted
    assert gru_cuda.gru_bidi_fused.launches == before
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r.astype(jnp.float32))
        assert tuple(g.shape) == r.shape
        atol = BF16_OUT_ATOL if i < 2 else H_LAST_ATOL
        assert g.dtype == (torch.bfloat16 if i < 2 else torch.float32)
        np.testing.assert_allclose(g.float().numpy(), r, atol=atol, rtol=0)
    pad = np.arange(t)[:, None] >= lens[None, :]
    for out in got[:2]:
        assert float(out.float().numpy()[pad].__abs__().max(initial=0.0)) == 0.0


@pytest.mark.parametrize(
    "t,lengths,d_in,hidden",
    [
        (13, [13, 1, 7, 12], 24, 16),
        (19, [19, 11, 6, 2, 19], 40, 32),
        (1, [1, 1], 8, 8),
    ],
)
def test_plain_fused_matches_pallas_interpret_f32(t, lengths, d_in, hidden):
    """B3 in float32, what compute_dtype="float32" serves: the plain version
    (the CUDA float32 variant's yardstick) against the Pallas kernel in
    interpret mode, both in float32 throughout: F32_ATOL (summation order)."""
    rng = np.random.default_rng(100 + t)
    x = rng.normal(size=(t, len(lengths), d_in)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    f, b = _weights(rng, d_in, hidden), _weights(rng, d_in, hidden)
    jf, jb = _jax_w(f), _jax_w(b)
    h0 = jnp.zeros((len(lengths), hidden), jnp.float32)
    ref = gru_scan_bidi_fused(
        jnp.asarray(x), jnp.asarray(lens),
        jf.w_ih, jb.w_ih, jf.w_hh, jb.w_hh, jf.b_ih, jb.b_ih, jf.b_hh, jb.b_hh,
        h0, h0, interpret=True,
    )
    tf, tb = _torch_w(f), _torch_w(b)
    got = gru_cuda.gru_bidi_fused(
        torch.from_numpy(x), torch.from_numpy(lens),
        tf.w_ih, tb.w_ih, tf.w_hh, tb.w_hh, tf.b_ih, tb.b_ih, tf.b_hh, tb.b_hh,
    )
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=F32_ATOL, rtol=0)
    pad = np.arange(t)[:, None] >= lens[None, :]
    for out in got[:2]:
        assert float(np.abs(out.numpy()[pad]).max(initial=0.0)) == 0.0


def _layer_inputs(seed, t=11, lengths=(11, 4, 1), d_in=12, hidden=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, len(lengths), d_in)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    return rng, x, lens, d_in, hidden


@pytest.mark.parametrize(
    "mode", ["bidi_sum", "bidi_concat", "uni", "uni_h0", "bidi_h0"]
)
def test_gru_layer_f32_matches_jax_xla(mode):
    rng, x, lens, d_in, hidden = _layer_inputs(1)
    f = _weights(rng, d_in, hidden)
    b = _weights(rng, d_in, hidden) if mode.startswith("bidi") else None
    ndir = 2 if b is not None else 1
    h0 = None
    if mode.endswith("h0"):
        h0 = rng.normal(size=(ndir, len(lens), hidden)).astype(np.float32) * 0.5
    kw = dict(sum_directions=mode != "bidi_concat")
    ref_out, ref_h = jrnn.gru_layer(
        jnp.asarray(x), jnp.asarray(lens), _jax_w(f),
        None if b is None else _jax_w(b),
        h0=None if h0 is None else jnp.asarray(h0), impl="xla", **kw,
    )
    got_out, got_h = trnn.gru_layer(
        torch.from_numpy(x), torch.from_numpy(lens), _torch_w(f),
        None if b is None else _torch_w(b),
        h0=None if h0 is None else torch.from_numpy(h0), **kw,
    )
    np.testing.assert_allclose(got_out.numpy(), np.asarray(ref_out), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_gru_layer_bidi_sum_bf16_matches_jax_pallas(impl):
    """The dispatch the model takes: bf16 weights, summed directions."""
    rng, x, lens, d_in, hidden = _layer_inputs(2)
    f, b = _weights(rng, d_in, hidden), _weights(rng, d_in, hidden)
    ref_out, ref_h = jrnn.gru_layer(
        jnp.asarray(x), jnp.asarray(lens), _jax_w(f, jnp.bfloat16),
        _jax_w(b, jnp.bfloat16), impl="pallas",
    )
    got_out, got_h = trnn.gru_layer(
        torch.from_numpy(x), torch.from_numpy(lens), _torch_w(f, torch.bfloat16),
        _torch_w(b, torch.bfloat16), impl=impl,
    )
    assert got_out.dtype == torch.float32
    # the sum of two bf16 outputs: up to one ulp each
    np.testing.assert_allclose(got_out.numpy(), np.asarray(ref_out),
                               atol=2 * BF16_OUT_ATOL, rtol=0)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), atol=H_LAST_ATOL, rtol=0)


def test_gru_layer_rejects_unknown_impl():
    _, x, lens, d_in, hidden = _layer_inputs(3)
    w = _torch_w(_weights(np.random.default_rng(0), d_in, hidden))
    with pytest.raises(ValueError):
        trnn.gru_layer(torch.from_numpy(x), torch.from_numpy(lens), w, w, impl="xla")


def _kernel_operands(hidden=8, d_in=12, t=5, batch=3):
    bf, f32 = torch.bfloat16, torch.float32
    return dict(
        x=torch.zeros((t, batch, d_in), dtype=bf),
        lengths=torch.full((batch,), t, dtype=torch.int32),
        w_ih_f=torch.zeros((d_in, 3 * hidden), dtype=bf),
        w_ih_b=torch.zeros((d_in, 3 * hidden), dtype=bf),
        w_hh_f=torch.zeros((hidden, 3 * hidden), dtype=bf),
        w_hh_b=torch.zeros((hidden, 3 * hidden), dtype=bf),
        biases=[torch.zeros(3 * hidden, dtype=f32) for _ in range(4)],
    )


@pytest.mark.parametrize(
    "field,bad,err",
    [
        # a float32 x with bf16 weights: a mixed set (the all-float32 set is
        # test_kernel_operand_sets')
        ("x", torch.zeros((5, 3, 12), dtype=torch.float32), TypeError),
        ("w_hh_b", torch.zeros((8, 25), dtype=torch.bfloat16), ValueError),
        ("lengths", torch.full((3,), 5, dtype=torch.int64), TypeError),
        ("w_ih_f", torch.zeros((24, 12), dtype=torch.bfloat16).t(), ValueError),
        ("x", torch.zeros((0, 3, 12), dtype=torch.bfloat16), ValueError),
    ],
)
def test_kernel_operand_checks(field, bad, err):
    ops = _kernel_operands()
    ops[field] = bad
    with pytest.raises(err):
        gru_cuda._check_operands(
            ops["x"], ops["lengths"], ops["w_ih_f"], ops["w_ih_b"],
            ops["w_hh_f"], ops["w_hh_b"], ops["biases"],
        )
    good = _kernel_operands()
    gru_cuda._check_operands(
        good["x"], good["lengths"], good["w_ih_f"], good["w_ih_b"],
        good["w_hh_f"], good["w_hh_b"], good["biases"],
    )


def _as_set(ops, dtype):
    """The operands as the set of ``dtype``: bf16 (bf16 x and weights, f32
    biases) or float32 (everything f32); lengths stay int32."""
    seq = torch.bfloat16 if dtype == "bf16" else torch.float32
    out = {k: v.to(seq) for k, v in ops.items() if k not in ("lengths", "biases")}
    return dict(out, lengths=ops["lengths"], biases=ops["biases"])


@pytest.mark.parametrize(
    "family,field,to,err",
    [
        ("bf16", None, None, None),
        ("float32", None, None, None),
        # mixed sets: one tensor of the other set's dtype
        ("float32", "w_hh_b", torch.bfloat16, TypeError),
        ("float32", "x", torch.bfloat16, TypeError),
        ("bf16", "w_ih_f", torch.float32, TypeError),
        ("float32", "lengths", torch.int64, TypeError),
        ("float32", "biases", torch.bfloat16, TypeError),
    ],
)
def test_kernel_operand_sets(family, field, to, err):
    """The CUDA branch takes the all-bf16 set or the all-float32 one, told
    apart by x's dtype, and returns which; a mixed set raises TypeError."""
    ops = _as_set(_kernel_operands(), family)
    if field == "biases":
        ops["biases"] = [b.to(to) for b in ops["biases"]]
    elif field is not None:
        ops[field] = ops[field].to(to)
    args = (ops["x"], ops["lengths"], ops["w_ih_f"], ops["w_ih_b"], ops["w_hh_f"],
            ops["w_hh_b"], ops["biases"])
    if err is not None:
        with pytest.raises(err):
            gru_cuda._check_operands(*args)
        return
    want = torch.bfloat16 if family == "bf16" else torch.float32
    assert gru_cuda._check_operands(*args) == want


def test_wrapper_raises_off_cpu_and_cuda():
    ops = _kernel_operands()
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else [b.to("meta") for b in v])
            for k, v in ops.items()}
    with pytest.raises(ValueError):
        gru_cuda.gru_bidi_fused(
            meta["x"], meta["lengths"], meta["w_ih_f"], meta["w_ih_b"],
            meta["w_hh_f"], meta["w_hh_b"], *meta["biases"],
        )


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No fallback: a missing compiler is an error, never the plain path."""
    (tmp_path / "k.cu").write_text("extern \"C\" int k() { return 0; }\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("k")


def test_chain_ptrs_fills_both_chains_of_a_launch():
    """A launch over one or two chains takes two pointers per operand; one
    chain passes its own twice, and an absent operand stays null."""
    a, b = torch.zeros(3), torch.zeros(3)
    assert cuda_build.chain_ptrs([a]) == [a.data_ptr(), a.data_ptr()]
    assert cuda_build.chain_ptrs([a, b]) == [a.data_ptr(), b.data_ptr()]
    assert cuda_build.chain_ptrs([None]) == [None, None]


def _fused_case(seed, t=9, lengths=(9, 3, 1, 7, 9), d_in=12, hidden=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, len(lengths), d_in)).astype(np.float32)
    f, b = _torch_w(_weights(rng, d_in, hidden), torch.bfloat16), \
        _torch_w(_weights(rng, d_in, hidden), torch.bfloat16)
    return (torch.from_numpy(x).to(torch.bfloat16), torch.tensor(lengths, dtype=torch.int32),
            f.w_ih, b.w_ih, f.w_hh, b.w_hh, f.b_ih, b.b_ih, f.b_hh, b.b_hh)


@pytest.mark.parametrize("rows_per_group,groups", [(1, 5), (2, 3), (3, 2), (5, 1)])
def test_gx_budget_splits_the_batch_into_groups_of_rows(monkeypatch, rows_per_group,
                                                        groups):
    """ROADMAP C14: where the f32 projection buffer (2, T, rows, 3H) would
    exceed the budget, gru_bidi_fused runs the batch in groups of rows, on
    the CPU as on the card. Rows of a recurrence are independent: the groups'
    bf16 outputs, side by side, equal one call's bit for bit. The f32 h_last
    may differ in its last bit (SPLIT_H_LAST_ATOL): the CPU's batched matrix
    product picks its kernel, and with it the order of its sums, by the
    number of rows."""
    args = _fused_case(3)
    t, batch, hidden = args[0].shape[0], args[0].shape[1], args[4].shape[0]
    whole = gru_cuda.gru_bidi_fused(*args)
    monkeypatch.setattr(gru_cuda, "GX_BUDGET_BYTES", rows_per_group * 2 * t * 3 * hidden * 4)
    assert gru_cuda.gx_row_groups(t, batch, hidden) == [
        slice(r, min(r + rows_per_group, batch)) for r in range(0, batch, rows_per_group)]
    sizes, plain = [], gru_cuda.gru_bidi_fused_plain
    monkeypatch.setattr(gru_cuda, "gru_bidi_fused_plain",
                        lambda x, *a: sizes.append(x.shape[1]) or plain(x, *a))
    split = gru_cuda.gru_bidi_fused(*args)
    assert len(sizes) == groups and sum(sizes) == batch
    assert max(sizes) <= rows_per_group
    for k, (g, w) in enumerate(zip(split, whole)):
        assert g.shape == w.shape and g.dtype == w.dtype
        if k < 2:
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, atol=SPLIT_H_LAST_ATOL, rtol=0)


def test_gx_budget_keeps_the_flagship_group_whole():
    """The flagship's 128-row group at T = 401 (1.48 GB of f32 projection)
    stays one launch; 128 one-minute clips (T = 3001, 11 GB) do not, and
    every group of theirs keeps within the 2 GiB budget."""
    assert gru_cuda.GX_BUDGET_BYTES == 2 << 30
    assert gru_cuda.gx_row_groups(401, 128, 1200) == [slice(0, 128)]
    groups = gru_cuda.gx_row_groups(3001, 128, 1200)
    assert len(groups) == 6 and groups[0] == slice(0, 24) and groups[-1] == slice(120, 128)
    for g in groups:
        assert 2 * 3001 * (g.stop - g.start) * 3 * 1200 * 4 <= gru_cuda.GX_BUDGET_BYTES
    # a row larger than the budget still runs, one row a group
    assert gru_cuda.gx_row_groups(10, 3, 8, budget=1) == [slice(0, 1), slice(1, 2),
                                                          slice(2, 3)]
