"""tanh-RNN kernels' plain versions and ``rnn_tanh_layer`` of the PyTorch
port against the JAX package (CPU).

The CUDA kernels ``rnn_tanh_scan`` and ``rnn_tanh_bwd_scan`` run only on the
card (chip_smoke.py holds them against their plain versions there). Here the
plain versions, which the wrappers run for CPU tensors, are held against the
JAX Pallas kernels with ``interpret=True``, and ``rnn_tanh_layer`` against
JAX ``rnn_tanh_layer`` (``impl="xla"`` and ``"pallas"``) and ``jax.grad``
through its custom VJP.

Tolerances: float32 differs by summation order only (F32_ATOL). With bf16
streams and weights both sides round the same operands at the same places
(gx with both biases inside, the bf16 copy of h, out): BF16_ATOL on values
in (-1, 1), one or two bf16 ulps. In the backward walk one flipped rounding
of a dpre element moves the carried dL/dh from there on: BF16_BWD_ATOL.
Layer gradients: GRAD_TOL, the bound of the JAX package's own gradient test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from danspeech_tpu.ops import pallas_gru as jk
from danspeech_tpu.ops import rnn as jrnn
from danspeech_tpu_torch.ops import rnn as trnn
from danspeech_tpu_torch.ops import rnn_tanh_cuda

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


def test_projection_holds_both_biases_and_the_walk_reads_the_output(monkeypatch):
    """The kernels' contract: gx = x @ w_ih + b_ih + b_hh rounded to the
    weights' dtype, and a backward walk that gets the direction's own output
    stream, opposite the chain's order."""
    seen = {}
    orig_scan = rnn_tanh_cuda.rnn_tanh_scan
    orig_bwd = rnn_tanh_cuda.rnn_tanh_bwd_scan

    def spy_scan(gx, lengths, w_hh, reverse=False):
        res = orig_scan(gx, lengths, w_hh, reverse=reverse)
        seen["gx", reverse], seen["out", reverse] = gx, res[0]
        return res

    def spy_bwd(out, dout, lengths, w_hh, reverse=True):
        seen["walk", reverse] = out
        return orig_bwd(out, dout, lengths, w_hh, reverse=reverse)

    monkeypatch.setattr(rnn_tanh_cuda, "rnn_tanh_scan", spy_scan)
    monkeypatch.setattr(rnn_tanh_cuda, "rnn_tanh_bwd_scan", spy_bwd)
    x, lens, fwd, bwd, r_out = _layer_case("bidi", True, [7, 4], seed=3)
    leaves = _torch_leaves(x, fwd, bwd)
    out = _torch_layer(leaves, lens, True, "auto", cast=torch.bfloat16)
    out.sum().backward()
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
    rnn_tanh_cuda._check_operands("gx", gx, lengths, w_hh)
    with pytest.raises(TypeError, match="A6b"):  # float32 streams are refused
        rnn_tanh_cuda._check_operands("gx", gx.float(), lengths, w_hh)
    with pytest.raises(ValueError, match="contiguous"):
        rnn_tanh_cuda._check_operands(
            "gx", gx.transpose(0, 1).contiguous().transpose(0, 1), lengths, w_hh)
    with pytest.raises(ValueError, match=r"\(H, H\)"):
        rnn_tanh_cuda._check_operands("gx", gx, lengths, w_hh[:, :4].contiguous())
    with pytest.raises(ValueError, match="shape"):
        rnn_tanh_cuda._check_operands("gx", gx, lengths[:1], w_hh)
