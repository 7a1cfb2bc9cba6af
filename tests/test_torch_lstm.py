"""LSTM kernels' plain versions and ``lstm_layer`` of the PyTorch port
against the JAX package (CPU).

The CUDA kernels ``lstm_scan``, ``lstm_scan_with_cell`` and ``lstm_bwd_scan``
run only on the card (chip_smoke.py holds them against their plain versions
there). Here the plain versions, which the wrappers run for CPU tensors, are
held against the JAX Pallas kernels with ``interpret=True``, and
``lstm_layer`` against JAX ``lstm_layer`` (``impl="xla"`` and ``"pallas"``)
and ``jax.grad`` through its custom VJP, as ``tests/test_pallas_grad.py``
runs it.

Tolerances: float32 differs by summation order only (F32_ATOL). With bf16
streams and weights both sides round the same operands at the same places
(the bf16 copy of h, out, c_seq), but for gx: the JAX package rounds
x @ w_ih + b_ih, the port x @ w_ih alone and adds b_ih + b_hh in f32 at
each step (ROADMAP C12): BF16_ATOL on values of order 1, one or two bf16
ulps. In the backward walk one flipped rounding of a dg4 element moves the
carried dL/dh from there on: BF16_BWD_ATOL. Layer gradients: GRAD_TOL, the bound of the JAX package's own
gradient test.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from danspeech_tpu.ops import pallas_gru as jk
from danspeech_tpu.ops import rnn as jrnn
from danspeech_tpu_torch.ops import lstm_cuda, walks
from danspeech_tpu_torch.ops import rnn as trnn

F32_ATOL = 1e-5
BF16_ATOL = 1e-2
BF16_BWD_ATOL = 3e-2
GRAD_TOL = 2e-4

CASES = [(13, [13, 0, 1, 7, 12], 16), (1, [1, 0], 8), (9, [9, 9], 24)]


def _dtypes(dtype):
    return ((jnp.float32, torch.float32) if dtype == "float32"
            else (jnp.bfloat16, torch.bfloat16))


def _scan_inputs(seed, t, lengths, hidden):
    rng = np.random.default_rng(seed)
    b = len(lengths)

    def f32(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return dict(
        gx=f32(t, b, 4 * hidden), lengths=np.asarray(lengths, np.int32),
        w_hh=f32(hidden, 4 * hidden, scale=0.3), b_hh=f32(4 * hidden, scale=0.3),
        h0=f32(b, hidden, scale=0.5), c0=f32(b, hidden, scale=0.5),
    )


@pytest.mark.parametrize("with_cell", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("t,lengths,hidden", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_scan_matches_pallas_interpret(dtype, t, lengths, hidden, reverse, with_cell):
    """Carried h0 and c0, ragged lengths with an empty and a full row, T = 1."""
    a = _scan_inputs(t + hidden, t, lengths, hidden)
    jdt, tdt = _dtypes(dtype)
    jfn = jk.lstm_scan_with_cell if with_cell else jk.lstm_scan
    tfn = lstm_cuda.lstm_scan_with_cell if with_cell else lstm_cuda.lstm_scan
    ref = jfn(
        jnp.asarray(a["gx"], jdt), jnp.asarray(a["lengths"]), jnp.asarray(a["w_hh"], jdt),
        jnp.asarray(a["b_hh"]), jnp.asarray(a["h0"]), jnp.asarray(a["c0"]),
        reverse=reverse, interpret=True,
    )
    before = tfn.launches
    got = tfn(
        torch.from_numpy(a["gx"]).to(tdt), torch.from_numpy(a["lengths"]),
        torch.from_numpy(a["w_hh"]).to(tdt), torch.from_numpy(a["b_hh"]),
        torch.from_numpy(a["h0"]), torch.from_numpy(a["c0"]), reverse=reverse,
    )
    # a CPU tensor runs the plain version: no kernel launch is counted
    assert tfn.launches == before
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    n_streams = 2 if with_cell else 1
    assert len(got) == len(ref) == n_streams + 2
    pad = np.arange(t)[:, None] >= a["lengths"][None, :]
    for k, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == (tdt if k < n_streams else torch.float32)
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32),
                                   atol=atol, rtol=0, err_msg=f"result {k}")
        if k < n_streams:  # out and c_seq: exact zeros past a row's length
            assert float(np.abs(g.float().numpy()[pad]).max(initial=0.0)) == 0.0
    # an empty row keeps its carried states
    for row, n in enumerate(lengths):
        if n == 0:
            np.testing.assert_array_equal(got[-2][row].numpy(), a["h0"][row])
            np.testing.assert_array_equal(got[-1][row].numpy(), a["c0"][row])


def test_cell_stream_is_rounded_where_the_backward_reads_it():
    """c_seq is the f32 cell state rounded to the stream dtype, c_last is
    not; out and the final states equal those of the scan without cells."""
    a = _scan_inputs(3, 6, [6, 4], 8)
    bf = torch.bfloat16
    args = (torch.from_numpy(a["gx"]).to(bf), torch.from_numpy(a["lengths"]),
            torch.from_numpy(a["w_hh"]).to(bf), torch.from_numpy(a["b_hh"]),
            torch.from_numpy(a["h0"]), torch.from_numpy(a["c0"]))
    out, cseq, h_last, c_last = lstm_cuda.lstm_scan_with_cell(*args)
    out2, h_last2, c_last2 = lstm_cuda.lstm_scan(*args)
    assert cseq.dtype == bf and c_last.dtype == torch.float32
    assert torch.equal(out, out2) and torch.equal(h_last, h_last2)
    assert torch.equal(c_last, c_last2)
    assert torch.equal(cseq[5, 0], c_last[0].to(bf))  # row 0 is full
    assert torch.equal(cseq[3, 1], c_last[1].to(bf))  # row 1 ends at t = 3


def _walk_inputs(seed, t, lengths, hidden):
    rng = np.random.default_rng(seed)
    b = len(lengths)

    def f32(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return dict(
        gx=f32(t, b, 4 * hidden, scale=0.5),
        hprev=rng.uniform(-1, 1, (t, b, hidden)).astype(np.float32),
        cprev=f32(t, b, hidden), dout=f32(t, b, hidden),
        lengths=np.asarray(lengths, np.int32),
        w_hh=f32(hidden, 4 * hidden, scale=0.3), b_hh=f32(4 * hidden, scale=0.3),
    )


@pytest.mark.parametrize("reverse", [True, False])
@pytest.mark.parametrize("t,lengths,hidden", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bwd_matches_pallas_interpret(dtype, t, lengths, hidden, reverse):
    a = _walk_inputs(t + hidden, t, lengths, hidden)
    jdt, tdt = _dtypes(dtype)
    ref = jk.lstm_bwd_scan(
        jnp.asarray(a["gx"], jdt), jnp.asarray(a["hprev"], jdt),
        jnp.asarray(a["cprev"], jdt), jnp.asarray(a["dout"]), jnp.asarray(a["lengths"]),
        jnp.asarray(a["w_hh"], jdt), jnp.asarray(a["b_hh"]),
        reverse=reverse, interpret=True,
    )
    before = lstm_cuda.lstm_bwd_scan.launches
    got = lstm_cuda.lstm_bwd_scan(
        torch.from_numpy(a["gx"]).to(tdt), torch.from_numpy(a["hprev"]).to(tdt),
        torch.from_numpy(a["cprev"]).to(tdt), torch.from_numpy(a["dout"]),
        torch.from_numpy(a["lengths"]), torch.from_numpy(a["w_hh"]).to(tdt),
        torch.from_numpy(a["b_hh"]), reverse=reverse,
    )
    assert lstm_cuda.lstm_bwd_scan.launches == before
    atol = F32_ATOL if dtype == "float32" else BF16_BWD_ATOL
    for name, g, r in zip(("dg4", "dh0", "dc0"), got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol, rtol=0,
                                   err_msg=name)
    # steps past a row's length give exact zeros; an empty row's carried
    # gradients stay at their zero start
    pad = np.arange(t)[:, None] >= a["lengths"][None, :]
    assert float(np.abs(got[0].numpy()[pad]).max(initial=0.0)) == 0.0
    for row, n in enumerate(lengths):
        if n == 0:
            assert float(got[1][row].abs().max()) == 0.0
            assert float(got[2][row].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# lstm_layer
# ---------------------------------------------------------------------------

SHAPES = [("uni", True), ("bidi", True), ("bidi", False)]


def _weights(rng, d_in, hidden, scale=0.3):
    return [
        (rng.normal(size=shape) * scale).astype(np.float32)
        for shape in ((d_in, 4 * hidden), (hidden, 4 * hidden), (4 * hidden,),
                      (4 * hidden,))
    ]


def _layer_case(direction, sum_directions, lens, seed):
    rng = np.random.default_rng(seed)
    t, d_in, hidden = max(max(lens), 1), 10, 8
    b = len(lens)
    x = rng.normal(size=(t, b, d_in)).astype(np.float32)
    fwd = _weights(rng, d_in, hidden)
    bwd = _weights(rng, d_in, hidden) if direction == "bidi" else None
    width = hidden * (2 if bwd is not None and not sum_directions else 1)
    r_out = rng.normal(size=(t, b, width)).astype(np.float32)
    return x, np.asarray(lens, np.int32), fwd, bwd, r_out


def _jax_layer(x, lens, fwd, bwd, sum_directions, impl, cast=None):
    jw = [jrnn.LSTMWeights(*map(jnp.asarray, w)) for w in (fwd, bwd) if w is not None]

    def run(x, *ws):
        if cast is not None:
            ws = [w._replace(w_ih=w.w_ih.astype(cast), w_hh=w.w_hh.astype(cast))
                  for w in ws]
        return jrnn.lstm_layer(x, jnp.asarray(lens), ws[0],
                               ws[1] if len(ws) > 1 else None,
                               sum_directions=sum_directions, impl=impl)

    return run, (jnp.asarray(x), *jw)


def _torch_leaves(x, fwd, bwd):
    leaves = [torch.from_numpy(x).requires_grad_(True)]
    for w in (fwd, bwd):
        if w is not None:
            leaves += [torch.from_numpy(a).requires_grad_(True) for a in w]
    return leaves


def _torch_layer(leaves, lens, sum_directions, impl, cast=None):
    def w(k):
        w = trnn.LSTMWeights(*leaves[1 + 4 * k : 5 + 4 * k])
        if cast is not None:
            w = w._replace(w_ih=w.w_ih.to(cast), w_hh=w.w_hh.to(cast))
        return w

    return trnn.lstm_layer(leaves[0], torch.from_numpy(lens), w(0),
                           w(1) if len(leaves) > 5 else None,
                           sum_directions=sum_directions, impl=impl)


@pytest.mark.parametrize("impl", ["auto", "plain"])
@pytest.mark.parametrize("direction,sum_directions", SHAPES)
@pytest.mark.parametrize("lens", [[13, 13, 13], [13, 7, 0, 4]])
def test_lstm_layer_forward_and_grads_match_jax(lens, direction, sum_directions, impl):
    """Forward against JAX ``impl="xla"`` and ``"pallas"``; gradients of
    sum(out * r) in x and every weight against jax.grad through the custom
    VJP."""
    x, lens, fwd, bwd, r_out = _layer_case(direction, sum_directions, lens,
                                           seed=len(lens) + sum_directions)
    leaves = _torch_leaves(x, fwd, bwd)
    out = _torch_layer(leaves, lens, sum_directions, impl)
    assert out.dtype == torch.float32
    for jimpl in ("xla", "pallas"):
        run, args = _jax_layer(x, lens, fwd, bwd, sum_directions, jimpl)
        ref = np.asarray(run(*args))
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.detach().numpy(), ref, atol=F32_ATOL, rtol=0,
                                   err_msg=jimpl)
    ref_grads = jax.grad(lambda *a: jnp.sum(run(*a) * r_out),
                         argnums=tuple(range(len(args))))(*args)
    ref_grads = [np.asarray(g) for g in jax.tree_util.tree_leaves(ref_grads)]
    got = torch.autograd.grad((out * torch.from_numpy(r_out)).sum(), leaves)
    assert len(got) == len(ref_grads) == (9 if bwd is not None else 5)
    for g, r in zip(got, ref_grads):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_lstm_layer_grads_match_autograd_through_the_plain_recurrence():
    """The Function's backward against torch autograd through the plain
    scans themselves (no Function, no backward walk)."""
    x, lens, fwd, bwd, r_out = _layer_case("bidi", False, [9, 5, 0], seed=11)
    leaves = _torch_leaves(x, fwd, bwd)
    got = torch.autograd.grad(
        (_torch_layer(leaves, lens, False, "auto") * torch.from_numpy(r_out)).sum(), leaves)
    tl = torch.from_numpy(lens)
    zeros = torch.zeros((len(lens), 8))
    outs = []
    for k, reverse in ((0, False), (1, True)):
        w = trnn.LSTMWeights(*leaves[1 + 4 * k : 5 + 4 * k])
        outs.append(lstm_cuda.lstm_scan_plain(
            leaves[0] @ w.w_ih + w.b_ih, tl, w.w_hh, w.b_hh, zeros, zeros,
            reverse=reverse)[0])
    auto = torch.autograd.grad(
        (torch.cat(outs, -1) * torch.from_numpy(r_out)).sum(), leaves)
    for g, a in zip(got, auto):
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=F32_ATOL, atol=F32_ATOL)


@pytest.mark.parametrize("direction,sum_directions", SHAPES)
def test_lstm_layer_bf16_close_to_jax_pallas(direction, sum_directions):
    """The dispatch of mixed precision: float32 x, bf16 weights cast inside
    the graph, float32 gradients back at the masters. Both packages round
    gx (the JAX package's with b_ih inside, the port's the bare product), h,
    out and c_seq to bf16 at the same places; a gradient of order 1-10 may
    differ by a few bf16 ulps of its largest terms."""
    x, lens, fwd, bwd, r_out = _layer_case(direction, sum_directions, [13, 7, 4], seed=5)
    run, args = _jax_layer(x, lens, fwd, bwd, sum_directions, "pallas",
                           cast=jnp.bfloat16)
    ref = np.asarray(run(*args))
    ref_grads = jax.grad(lambda *a: jnp.sum(run(*a) * r_out),
                         argnums=tuple(range(len(args))))(*args)
    ref_grads = [np.asarray(g) for g in jax.tree_util.tree_leaves(ref_grads)]
    leaves = _torch_leaves(x, fwd, bwd)
    out = _torch_layer(leaves, lens, sum_directions, "auto", cast=torch.bfloat16)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=2 * BF16_ATOL, rtol=0)
    got = torch.autograd.grad((out * torch.from_numpy(r_out)).sum(), leaves)
    for g, r in zip(got, ref_grads):
        assert g.dtype == torch.float32
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g.numpy(), r, atol=3e-2 * scale, rtol=0)


def _spy_walks(monkeypatch):
    """Records each chain walks.run is handed, as (the wrapper whose Walk it
    is, the chain, its reverse flag, its result); on CPU tensors the plain
    version runs once a chain."""
    kinds = {"lstm_scan": lstm_cuda.LSTM_SCAN,
             "lstm_scan_with_cell": lstm_cuda.LSTM_SCAN_WITH_CELL,
             "lstm_bwd_scan": lstm_cuda.LSTM_BWD_SCAN}
    seen, run = [], walks.run

    def spy(walk, chains, reverses, design=None):
        results = run(walk, chains, reverses, design)
        kind, = (k for k, w in kinds.items() if w is walk)
        seen.extend((kind, c, r, res) for c, r, res in zip(chains, reverses, results))
        return results

    monkeypatch.setattr(walks, "run", spy)
    return seen


def test_forward_keeps_the_cell_stream_only_when_differentiated(monkeypatch):
    """What jax.custom_vjp decides by tracing: ``lstm_scan`` for a forward
    that no gradient will follow, ``lstm_scan_with_cell`` for one that a
    gradient will, and one backward walk per direction (each chain of the
    dispatcher's, walks.run)."""
    seen = _spy_walks(monkeypatch)
    x, lens, fwd, bwd, r_out = _layer_case("bidi", True, [6, 3], seed=2)
    leaves = _torch_leaves(x, fwd, bwd)
    with torch.no_grad():
        quiet = _torch_layer(leaves, lens, True, "auto")
    assert [k for k, _, _, _ in seen] == ["lstm_scan"] * 2
    frozen = [t.detach() for t in leaves]  # grad mode on, nothing requires it
    _torch_layer(frozen, lens, True, "auto")
    assert [k for k, _, _, _ in seen] == ["lstm_scan"] * 4
    del seen[:]
    out = _torch_layer(leaves, lens, True, "auto")
    assert [k for k, _, _, _ in seen] == ["lstm_scan_with_cell"] * 2
    assert torch.equal(out.detach(), quiet)
    out.sum().backward()
    assert [k for k, _, _, _ in seen] == ["lstm_scan_with_cell"] * 2 + ["lstm_bwd_scan"] * 2
    assert [r for _, _, r, _ in seen] == [False, True, True, False]
    with pytest.raises(ValueError, match="unknown RNN impl"):
        _torch_layer(leaves, lens, True, "pallas")


def test_wrapper_operand_checks_and_devices():
    a = _walk_inputs(0, 5, [5, 3], 8)
    bf = torch.bfloat16
    gx = torch.from_numpy(a["gx"]).to(bf)
    lengths = torch.from_numpy(a["lengths"])
    w_hh, b_hh = torch.from_numpy(a["w_hh"]).to(bf), torch.from_numpy(a["b_hh"])
    zeros = torch.zeros((2, 8))
    for fn in (lstm_cuda.lstm_scan, lstm_cuda.lstm_scan_with_cell):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*(v.to("meta") for v in (gx, lengths, w_hh, b_hh, zeros, zeros)))
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_cuda.lstm_bwd_scan(*(v.to("meta") for v in (
            gx, torch.from_numpy(a["hprev"]).to(bf), torch.from_numpy(a["cprev"]).to(bf),
            torch.from_numpy(a["dout"]), lengths, w_hh, b_hh)))
    # the checks the CUDA branch makes before it launches
    assert lstm_cuda._check_scan_operands(gx, lengths, w_hh, b_hh, zeros,
                                          zeros) == torch.bfloat16
    # the all-float32 set is taken (the float32 variant, csrc/lstm_f32.cu)
    assert lstm_cuda._check_scan_operands(gx.float(), lengths, w_hh.float(), b_hh, zeros,
                                          zeros) == torch.float32
    with pytest.raises(TypeError, match="all-float32"):  # a mixed set is refused
        lstm_cuda._check_scan_operands(gx.float(), lengths, w_hh, b_hh, zeros, zeros)
    with pytest.raises(TypeError, match="bf16 sequences"):
        lstm_cuda._check_scan_operands(gx, lengths, w_hh.float(), b_hh, zeros, zeros)
    with pytest.raises(TypeError):
        lstm_cuda._check_scan_operands(gx, lengths.long(), w_hh, b_hh, zeros, zeros)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cuda._check_scan_operands(
            gx.transpose(0, 1).contiguous().transpose(0, 1), lengths, w_hh, b_hh,
            zeros, zeros)
    with pytest.raises(ValueError, match="4H"):
        lstm_cuda._check_scan_operands(gx[..., :24].contiguous(), lengths, w_hh, b_hh,
                                       zeros, zeros)
    with pytest.raises(ValueError, match="shape"):
        lstm_cuda._check_scan_operands(gx, lengths, w_hh, b_hh, zeros[:1], zeros)
    with pytest.raises(ValueError, match="empty"):
        lstm_cuda._check_scan_operands(gx[:0], lengths, w_hh, b_hh, zeros, zeros)


# ---------------------------------------------------------------------------
# lstm_scan_pair: both chains of a bidirectional layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_cell", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_equals_two_single_chains(dtype, with_cell):
    """On CPU tensors the pair runs the two chains one after the other through
    the single-chain wrappers (the plain versions): exactly their results."""
    _, tdt = _dtypes(dtype)
    lens = torch.tensor([13, 0, 1, 7, 12], dtype=torch.int32)
    chains = []
    for seed in (1, 2):
        a = _scan_inputs(seed, 13, lens.tolist(), 16)
        chains.append((torch.from_numpy(a["gx"]).to(tdt), lens,
                       torch.from_numpy(a["w_hh"]).to(tdt), torch.from_numpy(a["b_hh"]),
                       torch.from_numpy(a["h0"]), torch.from_numpy(a["c0"])))
    single = lstm_cuda.lstm_scan_with_cell if with_cell else lstm_cuda.lstm_scan
    before = single.launches
    got = lstm_cuda.lstm_scan_pair(chains[0], chains[1], False, True, with_cell=with_cell)
    assert single.launches == before
    for got_chain, chain, reverse in zip(got, chains, (False, True)):
        want = single(*chain, reverse=reverse)
        assert len(got_chain) == len(want) == (4 if with_cell else 3)
        for g, w in zip(got_chain, want):
            assert torch.equal(g, w)
    meta_lens = lens.to("meta")
    meta = [tuple(meta_lens if v is lens else v.to("meta") for v in c) for c in chains]
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_cuda.lstm_scan_pair(*meta, False, True, with_cell=with_cell)


@pytest.mark.parametrize("sum_directions", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bidi_layer_takes_the_pair_route(monkeypatch, dtype, sum_directions):
    """A bidirectional lstm_layer runs its two chains through lstm_scan_pair
    (one launch on the card): the result equals the two chains run by hand
    through the plain version over the bias-free product with b_ih + b_hh
    as the per-step bias, and matches the JAX package's lstm_layer
    (float32: ``impl="xla"``, F32_ATOL; bf16 weights: the Pallas kernel in
    interpret mode, the bound of test_lstm_layer_bf16_close_to_jax_pallas)."""
    pairs = []
    orig = lstm_cuda.lstm_scan_pair
    monkeypatch.setattr(lstm_cuda, "lstm_scan_pair",
                        lambda *a, **kw: pairs.append(kw.get("with_cell")) or orig(*a, **kw))
    x, lens, fwd, bwd, _ = _layer_case("bidi", sum_directions, [13, 7, 0, 4], seed=21)
    cast = None if dtype == "float32" else torch.bfloat16
    leaves = [t.detach() for t in _torch_leaves(x, fwd, bwd)]
    out = _torch_layer(leaves, lens, sum_directions, "auto", cast=cast)
    assert pairs == [False]
    tl = torch.from_numpy(lens)
    zeros = torch.zeros((len(lens), 8))
    by_hand = []
    for k, reverse in ((0, False), (1, True)):
        w = trnn.LSTMWeights(*leaves[1 + 4 * k : 5 + 4 * k])
        if cast is not None:
            w = w._replace(w_ih=w.w_ih.to(cast), w_hh=w.w_hh.to(cast))
        by_hand.append(lstm_cuda.lstm_scan_plain(
            trnn._lstm_product(leaves[0], w), tl, w.w_hh, trnn._lstm_bias(w), zeros, zeros,
            reverse=reverse)[0].float())
    want = by_hand[0] + by_hand[1] if sum_directions else torch.cat(by_hand, -1)
    assert torch.equal(out, want)
    run, args = _jax_layer(x, lens, fwd, bwd, sum_directions,
                           "xla" if cast is None else "pallas",
                           cast=None if cast is None else jnp.bfloat16)
    atol = F32_ATOL if cast is None else 2 * BF16_ATOL
    np.testing.assert_allclose(out.numpy(), np.asarray(run(*args)), atol=atol, rtol=0)


@pytest.mark.parametrize("direction", ["bidi", "uni"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_walks_read_the_bare_product_and_the_summed_bias(monkeypatch, dtype, direction):
    """What the layer hands each chain, forward and backward: gx the product
    x @ w_ih in the stream dtype, rounded once and holding no bias, and
    b_ih + b_hh in f32 as the per-step bias; the backward walk
    (``_lstm_walk_operands``) recomputes exactly the forward's operands
    (the plain routes add that bias as the kernels do)."""
    walked = _spy_walks(monkeypatch)
    x, lens, fwd, bwd, r_out = _layer_case(direction, True, [9, 6, 0, 3], seed=41)
    cast = None if dtype == "float32" else torch.bfloat16
    leaves = _torch_leaves(x, fwd, bwd)
    out = _torch_layer(leaves, lens, True, "auto", cast=cast)
    (out * torch.from_numpy(r_out)).sum().backward()
    # (gx, the per-step bias), wherever each signature puts the bias
    seen = {("fwd" if kind == "lstm_scan_with_cell" else "bwd", r):
            (c[0], c[3] if kind == "lstm_scan_with_cell" else c[6])
            for kind, c, r, _ in walked}
    stream = torch.float32 if cast is None else cast
    for k, reverse in enumerate((False, True)[: 1 + (bwd is not None)]):
        w_ih, _, b_ih, b_hh = (t.detach() for t in leaves[1 + 4 * k : 5 + 4 * k])
        gx, bias = seen["fwd", reverse]
        product = (leaves[0].detach().to(stream).float() @ w_ih.to(stream).float()).to(stream)
        assert gx.dtype == stream and torch.equal(gx, product)
        assert bias.dtype == torch.float32 and torch.equal(bias, b_ih + b_hh)
        # the backward of a chain walks opposite its order
        gx_b, bias_b = seen["bwd", not reverse]
        assert torch.equal(gx_b, gx) and torch.equal(bias_b, bias)


class _Ops(TorchDispatchMode):
    """The aten operations run under it, views left out."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func._schema.name.endswith(("view", "_unsafe_view")):
            self.ops.append((func._schema.name, args, out))
        return out


@pytest.mark.parametrize("direction", ["bidi", "uni"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_projection_span_runs_one_cast_and_the_products(monkeypatch, dtype, direction):
    """The operations inside ``model.rnn.project`` on the route the card
    takes (any device but the CPU: meta tensors here, the walk stubbed):
    one cast of x for the layer (none when x is already in the weights'
    dtype), one product per direction, and on the gate stream nothing else:
    no add, ``.float()``, cast or copy. The summed biases are 4H-wide."""
    counter = _Ops()

    @contextlib.contextmanager
    def spans(name):
        if name != "model.rnn.project":
            yield
            return
        with counter:
            yield

    def walk(gx, lengths, w_hh, b_hh, h0, c0, reverse=False):
        return gx.new_zeros(gx.shape[:2] + (w_hh.shape[0],)), h0, c0

    monkeypatch.setattr(trnn, "annotate", spans)
    monkeypatch.setattr(lstm_cuda, "lstm_scan", walk)
    monkeypatch.setattr(lstm_cuda, "lstm_scan_pair",
                        lambda a, b, ra, rb, with_cell: (walk(*a), walk(*b)))
    x, lens, fwd, bwd, _ = _layer_case(direction, True, [9, 6, 0, 3], seed=43)
    stream = torch.float32 if dtype == "float32" else torch.bfloat16
    dirs = [trnn.LSTMWeights(*(torch.from_numpy(a).to("meta") for a in w))
            for w in (fwd, bwd) if w is not None]
    dirs = [w._replace(w_ih=w.w_ih.to(stream), w_hh=w.w_hh.to(stream)) for w in dirs]
    xm = torch.from_numpy(x).to("meta")
    with torch.no_grad():
        out = trnn.lstm_layer(xm, torch.from_numpy(lens), *dirs)
    assert out.shape == (x.shape[0], x.shape[1], 8)
    names = [name for name, _, _ in counter.ops]
    assert names.count("aten::mm") == len(dirs)
    casts = [args[0] for name, args, _ in counter.ops if name == "aten::_to_copy"]
    assert len(casts) == (stream != torch.float32) and all(c is xm for c in casts)
    gate_elems = x.shape[0] * x.shape[1] * 4 * 8
    on_stream = [name for name, _, res in counter.ops if res.numel() == gate_elems]
    assert on_stream == ["aten::mm"] * len(dirs)
    assert sorted(names) == sorted(["aten::mm", "aten::add"] * len(dirs)
                                   + ["aten::_to_copy"] * len(casts))
    assert all(tuple(res.shape) == (32,) for name, _, res in counter.ops
               if name == "aten::add")


# ---------------------------------------------------------------------------
# lstm_bwd_scan_pair: both backward walks of a bidirectional layer
# ---------------------------------------------------------------------------


def _walk_chain(a, tdt, lengths):
    return (torch.from_numpy(a["gx"]).to(tdt), torch.from_numpy(a["hprev"]).to(tdt),
            torch.from_numpy(a["cprev"]).to(tdt), torch.from_numpy(a["dout"]), lengths,
            torch.from_numpy(a["w_hh"]).to(tdt), torch.from_numpy(a["b_hh"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_pair_matches_two_jax_walks(dtype):
    """On CPU tensors the pair is two lstm_bwd_scan calls (the plain
    version): chain a walks t = T-1 .. 0, chain b 0 .. T-1, over one ragged
    lengths tensor, each against JAX ``lstm_bwd_scan(interpret=True)`` with
    the tolerances of test_plain_bwd_matches_pallas_interpret."""
    jdt, tdt = _dtypes(dtype)
    lengths = [13, 0, 1, 7, 12]
    tl = torch.tensor(lengths, dtype=torch.int32)
    inputs = [_walk_inputs(seed, 13, lengths, 16) for seed in (31, 32)]
    before = (lstm_cuda.lstm_bwd_scan.launches, lstm_cuda.lstm_bwd_scan.chains)
    got = lstm_cuda.lstm_bwd_scan_pair(_walk_chain(inputs[0], tdt, tl),
                                       _walk_chain(inputs[1], tdt, tl), True, False)
    assert (lstm_cuda.lstm_bwd_scan.launches, lstm_cuda.lstm_bwd_scan.chains) == before
    atol = F32_ATOL if dtype == "float32" else BF16_BWD_ATOL
    pad = np.arange(13)[:, None] >= np.asarray(lengths)[None, :]
    for a, got_chain, reverse in zip(inputs, got, (True, False)):
        ref = jk.lstm_bwd_scan(
            jnp.asarray(a["gx"], jdt), jnp.asarray(a["hprev"], jdt),
            jnp.asarray(a["cprev"], jdt), jnp.asarray(a["dout"]), jnp.asarray(a["lengths"]),
            jnp.asarray(a["w_hh"], jdt), jnp.asarray(a["b_hh"]),
            reverse=reverse, interpret=True,
        )
        for name, g, r in zip(("dg4", "dh0", "dc0"), got_chain, ref):
            assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, name
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol, rtol=0,
                                       err_msg=f"{name} reverse={reverse}")
        assert float(np.abs(got_chain[0].numpy()[pad]).max(initial=0.0)) == 0.0


@pytest.mark.parametrize("design", [None, "persistent", "step"])
def test_bwd_design_argument_runs_the_plain_version_on_the_cpu(design):
    a = _walk_inputs(7, 9, [9, 4, 0], 8)
    chain = _walk_chain(a, torch.bfloat16, torch.from_numpy(a["lengths"]))
    counts = dict(lstm_cuda.lstm_bwd_scan.design_counts)
    want = lstm_cuda.lstm_bwd_scan_plain(*chain, reverse=False)
    for g, w in zip(lstm_cuda.lstm_bwd_scan(*chain, reverse=False, design=design), want):
        assert torch.equal(g, w)
    assert lstm_cuda.lstm_bwd_scan.design_counts == counts


def test_bwd_pair_refuses_chains_that_differ():
    lengths = torch.tensor([5, 3], dtype=torch.int32)
    a = _walk_chain(_walk_inputs(1, 5, [5, 3], 8), torch.float32, lengths)
    wider = _walk_chain(_walk_inputs(2, 5, [5, 3], 16), torch.float32, lengths)
    longer = _walk_chain(_walk_inputs(3, 6, [5, 3], 8), torch.float32, lengths)
    other_lengths = _walk_chain(_walk_inputs(4, 5, [5, 3], 8), torch.float32,
                                lengths.clone())
    for b in (wider, longer, other_lengths):
        with pytest.raises(ValueError, match="share their shapes and lengths"):
            lstm_cuda.lstm_bwd_scan_pair(a, b, True, False)
    meta = tuple(v.to("meta") for v in a)
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_cuda.lstm_bwd_scan_pair(meta, meta, True, False)


@pytest.mark.parametrize("sum_directions", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bidi_layer_backward_takes_the_bwd_pair_route(monkeypatch, dtype, sum_directions):
    """The backward of a bidirectional lstm_layer walks its two chains
    through lstm_bwd_scan_pair (one launch on the card; on the CPU two
    lstm_bwd_scan calls), the forward chain's walk in reverse time; the
    gradients equal jax.grad through the JAX package's lstm_layer (float32:
    ``impl="xla"`` to GRAD_TOL; bf16 weights: the Pallas kernels in
    interpret mode, the bound of test_lstm_layer_bf16_close_to_jax_pallas)."""
    pairs = []
    orig_pair = lstm_cuda.lstm_bwd_scan_pair
    monkeypatch.setattr(lstm_cuda, "lstm_bwd_scan_pair",
                        lambda a, b, **kw: pairs.append((kw["reverse_a"], kw["reverse_b"]))
                        or orig_pair(a, b, **kw))
    seen = _spy_walks(monkeypatch)
    x, lens, fwd, bwd, r_out = _layer_case("bidi", sum_directions, [13, 7, 0, 4], seed=23)
    cast = None if dtype == "float32" else torch.bfloat16
    leaves = _torch_leaves(x, fwd, bwd)
    out = _torch_layer(leaves, lens, sum_directions, "auto", cast=cast)
    got = torch.autograd.grad((out * torch.from_numpy(r_out)).sum(), leaves)
    walked = [r for kind, _, r, _ in seen if kind == "lstm_bwd_scan"]
    assert pairs == [(True, False)] and walked == [True, False]
    run, args = _jax_layer(x, lens, fwd, bwd, sum_directions,
                           "xla" if cast is None else "pallas",
                           cast=None if cast is None else jnp.bfloat16)
    ref_grads = jax.grad(lambda *a: jnp.sum(run(*a) * r_out),
                         argnums=tuple(range(len(args))))(*args)
    ref_grads = [np.asarray(g) for g in jax.tree_util.tree_leaves(ref_grads)]
    for g, r in zip(got, ref_grads):
        assert g.dtype == torch.float32
        if cast is None:
            np.testing.assert_allclose(g.numpy(), r, atol=GRAD_TOL, rtol=GRAD_TOL)
        else:
            scale = max(1.0, float(np.abs(r).max()))
            np.testing.assert_allclose(g.numpy(), r, atol=3e-2 * scale, rtol=0)
