"""tanh-RNN kernels' plain versions and ``rnn_tanh_layer`` of the PyTorch
port against the JAX package (CPU).

The CUDA kernels ``rnn_tanh_scan`` and ``rnn_tanh_bwd_scan`` run only on the
card (chip_smoke.py holds them against their plain versions there). Here the
plain versions, which the wrappers run for CPU tensors, are held against the
JAX Pallas kernels with ``interpret=True``, and ``rnn_tanh_layer`` against
JAX ``rnn_tanh_layer`` (``impl="xla"`` and ``"pallas"``) and ``jax.grad``
through its custom VJP. The pairs (both chains of a bidirectional layer)
run chain by chain on the CPU and are held against JAX the same way; what
each CUDA route would hand its C entry (the argument counts of the entry's
signature, the plan, the weight operand) is recorded on CPU tensors with
the build and the launch replaced.

Tolerances: float32 differs by summation order only (F32_ATOL). With bf16
streams and weights both sides round the same operands at the same places
(gx with both biases inside, the bf16 copy of h, out): BF16_ATOL on values
in (-1, 1), one or two bf16 ulps. In the backward walk one flipped rounding
of a dpre element moves the carried dL/dh from there on: BF16_BWD_ATOL.
Layer gradients: GRAD_TOL, the bound of the JAX package's own gradient test.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from danspeech_tpu.ops import pallas_gru as jk
from danspeech_tpu.ops import rnn as jrnn
from danspeech_tpu_torch.ops import cuda_build, gru_cuda
from danspeech_tpu_torch.ops import persist_plan as pp
from danspeech_tpu_torch.ops import rnn as trnn
from danspeech_tpu_torch.ops import rnn_tanh_cuda, walks

F32_ATOL = 1e-5
BF16_ATOL = 1e-2
BF16_BWD_ATOL = 3e-2
GRAD_TOL = 2e-4

CASES = [(13, [13, 0, 1, 7, 12], 16), (1, [1, 0], 8), (9, [9, 9], 24)]


def _dtypes(dtype):
    return ((jnp.float32, torch.float32) if dtype == "float32"
            else (jnp.bfloat16, torch.bfloat16))


def _inputs(seed, t, lengths, hidden):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    lengths = np.asarray(lengths, np.int32)
    out = rng.uniform(-1, 1, (t, b, hidden)).astype(np.float32)
    out *= (np.arange(t)[:, None] < lengths[None, :])[..., None]  # as the forward
    return dict(
        gx=rng.normal(size=(t, b, hidden)).astype(np.float32),
        out=out,
        dout=rng.normal(size=(t, b, hidden)).astype(np.float32),
        lengths=lengths,
        w_hh=(rng.normal(size=(hidden, hidden)) * 0.3).astype(np.float32),
    )


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("t,lengths,hidden", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_scan_matches_pallas_interpret(dtype, t, lengths, hidden, reverse):
    a = _inputs(t + hidden, t, lengths, hidden)
    jdt, tdt = _dtypes(dtype)
    ref = jk.rnn_tanh_scan(
        jnp.asarray(a["gx"], jdt), jnp.asarray(a["lengths"]), jnp.asarray(a["w_hh"], jdt),
        reverse=reverse, interpret=True,
    )
    before = rnn_tanh_cuda.rnn_tanh_scan.launches
    got = rnn_tanh_cuda.rnn_tanh_scan(
        torch.from_numpy(a["gx"]).to(tdt), torch.from_numpy(a["lengths"]),
        torch.from_numpy(a["w_hh"]).to(tdt), reverse=reverse,
    )
    # a CPU tensor runs the plain version: no kernel launch is counted
    assert rnn_tanh_cuda.rnn_tanh_scan.launches == before
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    assert got[0].dtype == tdt and got[1].dtype == torch.float32
    for name, g, r in zip(("out", "h_last"), got, ref):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32),
                                   atol=atol, rtol=0, err_msg=name)
    pad = np.arange(t)[:, None] >= a["lengths"][None, :]
    assert float(np.abs(got[0].float().numpy()[pad]).max(initial=0.0)) == 0.0
    for row, n in enumerate(lengths):
        if n == 0:  # an empty row never leaves the zero state
            assert float(got[1][row].abs().max()) == 0.0


@pytest.mark.parametrize("reverse", [True, False])
@pytest.mark.parametrize("t,lengths,hidden", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bwd_matches_pallas_interpret(dtype, t, lengths, hidden, reverse):
    a = _inputs(t + hidden + 1, t, lengths, hidden)
    jdt, tdt = _dtypes(dtype)
    ref = jk.rnn_tanh_bwd_scan(
        jnp.asarray(a["out"], jdt), jnp.asarray(a["dout"]), jnp.asarray(a["lengths"]),
        jnp.asarray(a["w_hh"], jdt), reverse=reverse, interpret=True,
    )
    before = rnn_tanh_cuda.rnn_tanh_bwd_scan.launches
    got = rnn_tanh_cuda.rnn_tanh_bwd_scan(
        torch.from_numpy(a["out"]).to(tdt), torch.from_numpy(a["dout"]),
        torch.from_numpy(a["lengths"]), torch.from_numpy(a["w_hh"]).to(tdt),
        reverse=reverse,
    )
    assert rnn_tanh_cuda.rnn_tanh_bwd_scan.launches == before
    atol = F32_ATOL if dtype == "float32" else BF16_BWD_ATOL
    for name, g, r in zip(("dpre", "dh0"), got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol, rtol=0,
                                   err_msg=name)
    pad = np.arange(t)[:, None] >= a["lengths"][None, :]
    assert float(np.abs(got[0].numpy()[pad]).max(initial=0.0)) == 0.0
    for row, n in enumerate(lengths):
        if n == 0:
            assert float(got[1][row].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# rnn_tanh_layer
# ---------------------------------------------------------------------------

SHAPES = [("uni", True), ("bidi", True), ("bidi", False)]


def _weights(rng, d_in, hidden, scale=0.3):
    return [
        (rng.normal(size=shape) * scale).astype(np.float32)
        for shape in ((d_in, hidden), (hidden, hidden), (hidden,), (hidden,))
    ]


def _layer_case(direction, sum_directions, lens, seed):
    rng = np.random.default_rng(seed)
    t, d_in, hidden = max(lens), 10, 8
    b = len(lens)
    x = rng.normal(size=(t, b, d_in)).astype(np.float32)
    fwd = _weights(rng, d_in, hidden)
    bwd = _weights(rng, d_in, hidden) if direction == "bidi" else None
    width = hidden * (2 if bwd is not None and not sum_directions else 1)
    r_out = rng.normal(size=(t, b, width)).astype(np.float32)
    return x, np.asarray(lens, np.int32), fwd, bwd, r_out


def _jax_layer(x, lens, fwd, bwd, sum_directions, impl, cast=None):
    jw = [jrnn.RNNWeights(*map(jnp.asarray, w)) for w in (fwd, bwd) if w is not None]

    def run(x, *ws):
        if cast is not None:
            ws = [w._replace(w_ih=w.w_ih.astype(cast), w_hh=w.w_hh.astype(cast))
                  for w in ws]
        return jrnn.rnn_tanh_layer(x, jnp.asarray(lens), ws[0],
                                   ws[1] if len(ws) > 1 else None,
                                   sum_directions=sum_directions, impl=impl)

    return run, (jnp.asarray(x), *jw)


def _jax_grads(run, args, r_out):
    grads = jax.grad(lambda *a: jnp.sum(run(*a) * r_out),
                     argnums=tuple(range(len(args))))(*args)
    return [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


def _torch_leaves(x, fwd, bwd):
    leaves = [torch.from_numpy(x).requires_grad_(True)]
    for w in (fwd, bwd):
        if w is not None:
            leaves += [torch.from_numpy(a).requires_grad_(True) for a in w]
    return leaves


def _torch_layer(leaves, lens, sum_directions, impl, cast=None):
    def w(k):
        w = trnn.RNNWeights(*leaves[1 + 4 * k : 5 + 4 * k])
        if cast is not None:
            w = w._replace(w_ih=w.w_ih.to(cast), w_hh=w.w_hh.to(cast))
        return w

    return trnn.rnn_tanh_layer(leaves[0], torch.from_numpy(lens), w(0),
                               w(1) if len(leaves) > 5 else None,
                               sum_directions=sum_directions, impl=impl)


@pytest.mark.parametrize("impl", ["auto", "plain"])
@pytest.mark.parametrize("direction,sum_directions", SHAPES)
@pytest.mark.parametrize("lens", [[13, 13, 13], [13, 7, 0, 4]])
def test_rnn_tanh_layer_forward_and_grads_match_jax(lens, direction, sum_directions, impl):
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
    ref_grads = _jax_grads(run, args, r_out)
    got = torch.autograd.grad((out * torch.from_numpy(r_out)).sum(), leaves)
    assert len(got) == len(ref_grads) == (9 if bwd is not None else 5)
    for g, r in zip(got, ref_grads):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=GRAD_TOL, atol=GRAD_TOL)
    # b_ih and b_hh enter the pre-activation additively: equal gradients
    assert torch.equal(got[3], got[4])


@pytest.mark.parametrize("direction,sum_directions", SHAPES)
def test_rnn_tanh_layer_bf16_close_to_jax_pallas(direction, sum_directions):
    """Mixed precision: float32 x, bf16 weights cast inside the graph,
    float32 gradients back at the masters; a gradient of order 1-10 may
    differ by a few bf16 ulps of its largest terms."""
    x, lens, fwd, bwd, r_out = _layer_case(direction, sum_directions, [13, 7, 4], seed=5)
    run, args = _jax_layer(x, lens, fwd, bwd, sum_directions, "pallas",
                           cast=jnp.bfloat16)
    ref = np.asarray(run(*args))
    ref_grads = _jax_grads(run, args, r_out)
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
    seen, run = [], walks.run

    def spy(walk, chains, reverses, design=None):
        results = run(walk, chains, reverses, design)
        kind = "scan" if walk is rnn_tanh_cuda.RNN_TANH_SCAN else "bwd"
        seen.extend((kind, c, r, res) for c, r, res in zip(chains, reverses, results))
        return results

    monkeypatch.setattr(walks, "run", spy)
    return seen


def test_projection_holds_both_biases_and_the_walk_reads_the_output(monkeypatch):
    """The kernels' contract: gx = x @ w_ih + b_ih + b_hh rounded to the
    weights' dtype, and a backward walk that gets the direction's own output
    stream, opposite the chain's order."""
    walked = _spy_walks(monkeypatch)
    x, lens, fwd, bwd, r_out = _layer_case("bidi", True, [7, 4], seed=3)
    leaves = _torch_leaves(x, fwd, bwd)
    out = _torch_layer(leaves, lens, True, "auto", cast=torch.bfloat16)
    out.sum().backward()
    seen = {}
    for kind, chain, reverse, res in walked:
        if kind == "scan":
            seen["gx", reverse], seen["out", reverse] = chain[0], res[0]
        else:
            seen["walk", reverse] = chain[0]
    for k, reverse in ((0, False), (1, True)):
        w_ih, _, b_ih, b_hh = leaves[1 + 4 * k : 5 + 4 * k]
        want = (leaves[0].detach().bfloat16().float() @ w_ih.detach().bfloat16().float()
                + (b_ih + b_hh).detach()).bfloat16()
        assert seen["gx", reverse].dtype == torch.bfloat16
        assert torch.equal(seen["gx", reverse], want)
        assert torch.equal(seen["walk", not reverse], seen["out", reverse])


def test_wrapper_operand_checks_and_devices():
    a = _inputs(0, 5, [5, 3], 8)
    bf = torch.bfloat16
    gx = torch.from_numpy(a["gx"]).to(bf)
    lengths = torch.from_numpy(a["lengths"])
    w_hh = torch.from_numpy(a["w_hh"]).to(bf)
    dout = torch.from_numpy(a["dout"])
    with pytest.raises(ValueError, match="unsupported device"):
        rnn_tanh_cuda.rnn_tanh_scan(*(v.to("meta") for v in (gx, lengths, w_hh)))
    with pytest.raises(ValueError, match="unsupported device"):
        rnn_tanh_cuda.rnn_tanh_bwd_scan(*(v.to("meta") for v in (gx, dout, lengths, w_hh)))
    # the checks the CUDA branch makes before it launches
    assert rnn_tanh_cuda._check_operands("gx", gx, lengths, w_hh) == torch.bfloat16
    # the all-float32 set is taken (the float32 variant, csrc/rnn_tanh_f32.cu)
    assert rnn_tanh_cuda._check_operands("gx", gx.float(), lengths,
                                         w_hh.float()) == torch.float32
    assert rnn_tanh_cuda._check_bwd_operands(gx.float(), dout, lengths,
                                             w_hh.float()) == torch.float32
    with pytest.raises(TypeError, match="all-float32"):  # a mixed set is refused
        rnn_tanh_cuda._check_operands("gx", gx.float(), lengths, w_hh)
    with pytest.raises(TypeError, match="bf16 sequences"):
        rnn_tanh_cuda._check_bwd_operands(gx, dout, lengths, w_hh.float())
    with pytest.raises(ValueError, match="contiguous"):
        rnn_tanh_cuda._check_operands(
            "gx", gx.transpose(0, 1).contiguous().transpose(0, 1), lengths, w_hh)
    with pytest.raises(ValueError, match=r"\(H, H\)"):
        rnn_tanh_cuda._check_operands("gx", gx, lengths, w_hh[:, :4].contiguous())
    with pytest.raises(ValueError, match="shape"):
        rnn_tanh_cuda._check_operands("gx", gx, lengths[:1], w_hh)


# ---------------------------------------------------------------------------
# The pairs: both chains of a bidirectional layer, and the design argument
# ---------------------------------------------------------------------------

PAIR_LENGTHS = [13, 0, 1, 7, 12]


def _scan_chain(a, tdt, lengths):
    return (torch.from_numpy(a["gx"]).to(tdt), lengths, torch.from_numpy(a["w_hh"]).to(tdt))


def _walk_chain(a, tdt, lengths):
    return (torch.from_numpy(a["out"]).to(tdt), torch.from_numpy(a["dout"]), lengths,
            torch.from_numpy(a["w_hh"]).to(tdt))


def _counters():
    return [(w.launches, w.chains, dict(w.design_counts))
            for w in (rnn_tanh_cuda.rnn_tanh_scan, rnn_tanh_cuda.rnn_tanh_bwd_scan)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_pair_matches_two_jax_chains(dtype):
    """On CPU tensors the pair is two rnn_tanh_scan calls (the plain
    version): chain a walks t = 0 .. T-1, chain b T-1 .. 0, over one ragged
    lengths tensor, each against JAX ``rnn_tanh_scan(interpret=True)`` with
    the tolerances of test_plain_scan_matches_pallas_interpret."""
    jdt, tdt = _dtypes(dtype)
    tl = torch.tensor(PAIR_LENGTHS, dtype=torch.int32)
    inputs = [_inputs(seed, 13, PAIR_LENGTHS, 16) for seed in (41, 42)]
    before = _counters()
    got = rnn_tanh_cuda.rnn_tanh_scan_pair(_scan_chain(inputs[0], tdt, tl),
                                           _scan_chain(inputs[1], tdt, tl), False, True)
    assert _counters() == before
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    pad = np.arange(13)[:, None] >= np.asarray(PAIR_LENGTHS)[None, :]
    for a, got_chain, reverse in zip(inputs, got, (False, True)):
        ref = jk.rnn_tanh_scan(jnp.asarray(a["gx"], jdt), jnp.asarray(a["lengths"]),
                               jnp.asarray(a["w_hh"], jdt), reverse=reverse, interpret=True)
        assert got_chain[0].dtype == tdt and got_chain[1].dtype == torch.float32
        for name, g, r in zip(("out", "h_last"), got_chain, ref):
            assert tuple(g.shape) == r.shape, name
            np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32),
                                       atol=atol, rtol=0, err_msg=f"{name} reverse={reverse}")
        assert float(np.abs(got_chain[0].float().numpy()[pad]).max(initial=0.0)) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_pair_matches_two_jax_walks(dtype):
    """On CPU tensors the pair is two rnn_tanh_bwd_scan calls: chain a walks
    t = T-1 .. 0 (the backward of the forward chain), chain b 0 .. T-1, each
    against JAX ``rnn_tanh_bwd_scan(interpret=True)`` with the tolerances of
    test_plain_bwd_matches_pallas_interpret."""
    jdt, tdt = _dtypes(dtype)
    tl = torch.tensor(PAIR_LENGTHS, dtype=torch.int32)
    inputs = [_inputs(seed, 13, PAIR_LENGTHS, 16) for seed in (43, 44)]
    before = _counters()
    got = rnn_tanh_cuda.rnn_tanh_bwd_scan_pair(_walk_chain(inputs[0], tdt, tl),
                                               _walk_chain(inputs[1], tdt, tl), True, False)
    assert _counters() == before
    atol = F32_ATOL if dtype == "float32" else BF16_BWD_ATOL
    pad = np.arange(13)[:, None] >= np.asarray(PAIR_LENGTHS)[None, :]
    for a, got_chain, reverse in zip(inputs, got, (True, False)):
        ref = jk.rnn_tanh_bwd_scan(
            jnp.asarray(a["out"], jdt), jnp.asarray(a["dout"]), jnp.asarray(a["lengths"]),
            jnp.asarray(a["w_hh"], jdt), reverse=reverse, interpret=True)
        for name, g, r in zip(("dpre", "dh0"), got_chain, ref):
            assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, name
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol, rtol=0,
                                       err_msg=f"{name} reverse={reverse}")
        assert float(np.abs(got_chain[0].numpy()[pad]).max(initial=0.0)) == 0.0


@pytest.mark.parametrize("kind", ["scan", "bwd"])
def test_pairs_refuse_chains_that_differ(kind):
    pair = (rnn_tanh_cuda.rnn_tanh_scan_pair if kind == "scan"
            else rnn_tanh_cuda.rnn_tanh_bwd_scan_pair)
    chain = _scan_chain if kind == "scan" else _walk_chain
    lengths = torch.tensor([5, 3], dtype=torch.int32)
    a = chain(_inputs(1, 5, [5, 3], 8), torch.float32, lengths)
    wider = chain(_inputs(2, 5, [5, 3], 16), torch.float32, lengths)
    longer = chain(_inputs(3, 6, [5, 3], 8), torch.float32, lengths)
    other_lengths = chain(_inputs(4, 5, [5, 3], 8), torch.float32, lengths.clone())
    for b in (wider, longer, other_lengths):
        with pytest.raises(ValueError, match="share their shapes and lengths"):
            pair(a, b, False, True)
        with pytest.raises(ValueError, match="share their shapes and lengths"):
            pair(tuple(v.to("meta") for v in a), tuple(v.to("meta") for v in b), False, True)
    meta = tuple(v.to("meta") for v in a)
    with pytest.raises(ValueError, match="unsupported device"):
        pair(meta, meta, False, True)


@pytest.mark.parametrize("design", [None, "persistent", "step"])
def test_design_argument_runs_the_plain_version_on_the_cpu(design):
    """rnn_tanh_scan, rnn_tanh_bwd_scan and their pairs on CPU tensors run
    the plain versions whatever the design, as the LSTM wrappers do, and
    count nothing."""
    tl = torch.tensor([9, 4, 0], dtype=torch.int32)
    a, b = _inputs(7, 9, [9, 4, 0], 8), _inputs(8, 9, [9, 4, 0], 8)
    bf = torch.bfloat16
    before = _counters()
    for reverse in (False, True):
        for g, w in zip(rnn_tanh_cuda.rnn_tanh_scan(*_scan_chain(a, bf, tl), reverse=reverse,
                                                    design=design),
                        rnn_tanh_cuda.rnn_tanh_scan_plain(*_scan_chain(a, bf, tl), reverse)):
            assert torch.equal(g, w)
        for g, w in zip(rnn_tanh_cuda.rnn_tanh_bwd_scan(*_walk_chain(a, bf, tl),
                                                        reverse=reverse, design=design),
                        rnn_tanh_cuda.rnn_tanh_bwd_scan_plain(*_walk_chain(a, bf, tl), reverse)):
            assert torch.equal(g, w)
    scans = rnn_tanh_cuda.rnn_tanh_scan_pair(_scan_chain(a, bf, tl), _scan_chain(b, bf, tl),
                                             False, True, design=design)
    walks = rnn_tanh_cuda.rnn_tanh_bwd_scan_pair(_walk_chain(a, bf, tl), _walk_chain(b, bf, tl),
                                                 True, False, design=design)
    for x, got, reverse in ((a, scans[0], False), (b, scans[1], True)):
        for g, w in zip(got, rnn_tanh_cuda.rnn_tanh_scan_plain(*_scan_chain(x, bf, tl), reverse)):
            assert torch.equal(g, w)
    for x, got, reverse in ((a, walks[0], True), (b, walks[1], False)):
        for g, w in zip(got, rnn_tanh_cuda.rnn_tanh_bwd_scan_plain(*_walk_chain(x, bf, tl),
                                                                   reverse)):
            assert torch.equal(g, w)
    assert _counters() == before


@pytest.mark.parametrize("sum_directions", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bidi_layer_takes_the_pair_routes(monkeypatch, dtype, sum_directions):
    """A bidirectional rnn_tanh_layer runs its two chains through
    rnn_tanh_scan_pair and its two backward walks through
    rnn_tanh_bwd_scan_pair (one launch each on the card; on the CPU two
    calls each), the forward chain's walk in reverse time. The output equals
    the two chains run by hand through the plain version; output and
    gradients match the JAX package's rnn_tanh_layer (float32:
    ``impl="xla"``, F32_ATOL and GRAD_TOL; bf16 weights: the Pallas kernels
    in interpret mode, the bounds of test_rnn_tanh_layer_bf16_close_to_jax_pallas)."""
    pairs = []
    orig_pair = rnn_tanh_cuda.rnn_tanh_scan_pair
    orig_bwd_pair = rnn_tanh_cuda.rnn_tanh_bwd_scan_pair
    monkeypatch.setattr(rnn_tanh_cuda, "rnn_tanh_scan_pair",
                        lambda a, b, ra, rb: pairs.append(("scan", ra, rb))
                        or orig_pair(a, b, ra, rb))
    monkeypatch.setattr(rnn_tanh_cuda, "rnn_tanh_bwd_scan_pair",
                        lambda a, b, **kw: pairs.append(("bwd", kw["reverse_a"], kw["reverse_b"]))
                        or orig_bwd_pair(a, b, **kw))
    seen = _spy_walks(monkeypatch)
    x, lens, fwd, bwd, r_out = _layer_case("bidi", sum_directions, [13, 7, 0, 4], seed=27)
    cast = None if dtype == "float32" else torch.bfloat16
    leaves = _torch_leaves(x, fwd, bwd)
    out = _torch_layer(leaves, lens, sum_directions, "auto", cast=cast)
    assert pairs == [("scan", False, True)]
    tl = torch.from_numpy(lens)
    by_hand = []
    for k, reverse in ((0, False), (1, True)):
        w = trnn.RNNWeights(*(t.detach() for t in leaves[1 + 4 * k : 5 + 4 * k]))
        if cast is not None:
            w = w._replace(w_ih=w.w_ih.to(cast), w_hh=w.w_hh.to(cast))
        by_hand.append(rnn_tanh_cuda.rnn_tanh_scan_plain(
            trnn._rnn_project(leaves[0].detach(), w), tl, w.w_hh, reverse=reverse)[0].float())
    want = by_hand[0] + by_hand[1] if sum_directions else torch.cat(by_hand, -1)
    assert torch.equal(out.detach(), want)
    got = torch.autograd.grad((out * torch.from_numpy(r_out)).sum(), leaves)
    walked = [r for kind, _, r, _ in seen if kind == "bwd"]
    assert pairs == [("scan", False, True), ("bwd", True, False)] and walked == [True, False]
    run, args = _jax_layer(x, lens, fwd, bwd, sum_directions,
                           "xla" if cast is None else "pallas",
                           cast=None if cast is None else jnp.bfloat16)
    atol = F32_ATOL if cast is None else 2 * BF16_ATOL
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(run(*args)), atol=atol, rtol=0)
    for g, r in zip(got, _jax_grads(run, args, r_out)):
        assert g.dtype == torch.float32
        if cast is None:
            np.testing.assert_allclose(g.numpy(), r, atol=GRAD_TOL, rtol=GRAD_TOL)
        else:
            scale = max(1.0, float(np.abs(r).max()))
            np.testing.assert_allclose(g.numpy(), r, atol=3e-2 * scale, rtol=0)


# ---------------------------------------------------------------------------
# What the routes hand their C entries (recorded on CPU tensors, no launch)
# ---------------------------------------------------------------------------


def _c_signature(source, fn_name):
    """(pointer parameters, int parameters) of ``extern "C" int fn_name(...)``
    in csrc/<source>.cu, in order, the trailing stream left out; the
    pointers must all come before the ints."""
    with open(os.path.join(cuda_build.CSRC_DIR, f"{source}.cu")) as f:
        text = re.sub(r"//[^\n]*", "", f.read())
    m = re.search(r'extern "C" int ' + fn_name + r"\((.*?)\)\s*\{", text, re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    assert params[-1] == "void* stream"
    kinds = ["ptr" if "*" in p else "int" for p in params[:-1]]
    assert all(p.startswith("int ") for p, k in zip(params, kinds) if k == "int")
    assert kinds == sorted(kinds, key=lambda k: k != "ptr"), "pointers first, then ints"
    return kinds.count("ptr"), kinds.count("int")


class _Recorder:
    """Stands in for cuda_build.bind and cuda_build.call: records what a
    route binds and the arguments it would launch with."""

    def __init__(self, monkeypatch):
        self.bound, self.calls = [], []
        monkeypatch.setattr(cuda_build, "bind",
                            lambda *a: self.bound.append(a) or a)
        monkeypatch.setattr(cuda_build, "call",
                            lambda fn, name, dev, *args: self.calls.append((fn, args)))


def _route_operands(chains=1):
    """Operand tuples of ``chains`` chains, T=6 B=3 H=16, over one lengths
    tensor: (scan chains, backward walks)."""
    tl = torch.tensor([6, 2, 0], dtype=torch.int32)
    bf = torch.bfloat16
    inputs = [_inputs(11 + k, 6, [6, 2, 0], 16) for k in range(chains)]
    return ([_scan_chain(a, bf, tl) for a in inputs], [_walk_chain(a, bf, tl) for a in inputs])


@pytest.mark.parametrize("route,chains", [
    ("scan step", 1), ("scan persistent", 1), ("scan persistent", 2),
    ("bwd step", 1), ("bwd persistent", 1), ("bwd persistent", 2),
])
def test_routes_match_their_c_entries(monkeypatch, route, chains):
    """Each route binds its entry with the C signature's numbers of pointers
    and ints and passes exactly those: the shape, the walk's direction
    and, on the persistent routes, the chains and the plan."""
    rec = _Recorder(monkeypatch)
    scan, walk = _route_operands(chains=chains)
    plan_fn = pp.plan_rnn_tanh_forward if route.startswith("scan") else pp.plan_rnn_tanh_backward
    planned = plan_fn(16, 3, chains, pp.H100_SMS, pp.H100_SMEM_OPTIN)
    reverses = [False, True][:chains]
    if route == "scan step":
        rnn_tanh_cuda._scan_step(*scan[0], False)
    elif route == "scan persistent":
        outs = rnn_tanh_cuda._scan_persistent(scan, reverses, planned)
        assert [tuple(o.shape) for o in outs[-1]] == [(6, 3, 16), (3, 16)]
    elif route == "bwd step":
        rnn_tanh_cuda._bwd_step(*walk[0], False)
    else:
        outs = rnn_tanh_cuda._bwd_persistent(walk, reverses, planned)
        assert [(tuple(o.shape), o.dtype) for o in outs[-1]] \
            == [((6, 3, 16), torch.float32), ((3, 16), torch.float32)]
    (source, fn_name, n_ptr, n_int), = rec.bound
    assert (n_ptr, n_int) == _c_signature(source, fn_name)
    (_, args), = rec.calls
    assert len(args) == n_ptr + n_int
    ints = list(args[n_ptr:])
    if route.endswith("step"):
        assert ints == [6, 3, 16, 0]
    else:
        assert ints == [6, 3, 16, 0, int(reverses[-1]), chains, planned.units,
                        planned.row_groups, planned.stages, planned.chunk_depth,
                        planned.blocks_per_dir, planned.smem_bytes]


def test_weight_operands_of_the_routes(monkeypatch):
    """The forward's persistent route and the backward's step route read
    w_hh^T from gru_cuda.transposed (one copy per weight tensor and version,
    not one per call); the backward's persistent route reads w_hh as it lies,
    with no transpose."""
    rec = _Recorder(monkeypatch)
    scan, walk = _route_operands()
    w_hh = walk[0][3]
    plan_f = pp.plan_rnn_tanh_forward(16, 3, 1, pp.H100_SMS, pp.H100_SMEM_OPTIN)
    plan_b = pp.plan_rnn_tanh_backward(16, 3, 1, pp.H100_SMS, pp.H100_SMEM_OPTIN)
    for _ in range(2):
        rnn_tanh_cuda._bwd_step(*walk[0], True)
    rnn_tanh_cuda._scan_persistent([scan[0]], [False], plan_f)
    rnn_tanh_cuda._bwd_persistent([walk[0]], [True], plan_b)
    w_hht = gru_cuda.transposed(w_hh)
    assert torch.equal(w_hht, w_hh.t()) and w_hht.is_contiguous()
    step_1, step_2, fwd, bwd = (args for _, args in rec.calls)
    assert step_1[3] == step_2[3] == w_hht.data_ptr()  # kept, not remade per call
    assert fwd[3] == fwd[4] == gru_cuda.transposed(scan[0][2]).data_ptr()
    assert bwd[5] == bwd[6] == w_hh.data_ptr()
    w_hh.mul_(2.0)  # an optimizer step bumps the version: a new transpose
    rnn_tanh_cuda._bwd_step(*walk[0], True)
    assert torch.equal(gru_cuda.transposed(w_hh), w_hh.t())
    assert rec.calls[-1][1][3] == gru_cuda.transposed(w_hh).data_ptr()
