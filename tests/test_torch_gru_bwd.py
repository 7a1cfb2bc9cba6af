"""GRU backward of the PyTorch port against the JAX package (CPU).

The CUDA kernel ``gru_bwd_scan`` runs only on the card (chip_smoke.py holds
it against its plain version there). Here its plain version, which the
wrapper runs for CPU tensors, is held against JAX
``gru_bwd_scan(interpret=True)``, and the ``torch.autograd.Function``s of
``ops/rnn.py`` against ``jax.grad`` through ``gru_layer(impl="pallas")`` as
``tests/test_pallas_grad.py`` runs it.

Tolerances: float32 walks differ by summation order only (F32_ATOL). With
bf16 streams and weights both sides round the same operands, but one bf16
rounding of a dgh element that flips (2^-8 of a value of order 1) moves the
carried dL/dh from there on: BF16_ATOL. Layer gradients: GRAD_TOL, the bound
of the JAX package's own gradient test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from danspeech_tpu.ops import rnn as jrnn
from danspeech_tpu.ops.pallas_gru import gru_bwd_scan as j_gru_bwd_scan
from danspeech_tpu_torch.ops import gru_cuda
from danspeech_tpu_torch.ops import rnn as trnn

F32_ATOL = 1e-5
BF16_ATOL = 3e-2
GRAD_TOL = 2e-4


def _walk_inputs(seed, t, lengths, hidden):
    rng = np.random.default_rng(seed)
    b = len(lengths)

    def f32(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return dict(
        gx=f32(t, b, 3 * hidden, scale=0.5),
        hprev=rng.uniform(-1, 1, (t, b, hidden)).astype(np.float32),
        dout=f32(t, b, hidden),
        lengths=np.asarray(lengths, np.int32),
        w_hh=f32(hidden, 3 * hidden, scale=0.3),
        b_ih=f32(3 * hidden, scale=0.3),
        b_hh=f32(3 * hidden, scale=0.3),
        dh_last=f32(b, hidden),
    )


@pytest.mark.parametrize("reverse", [True, False])
@pytest.mark.parametrize(
    "t,lengths,hidden",
    [(13, [13, 0, 1, 7, 12], 16), (1, [1, 0], 8), (9, [9, 9], 24)],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bwd_matches_pallas_interpret(dtype, t, lengths, hidden, reverse):
    a = _walk_inputs(t + hidden, t, lengths, hidden)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = j_gru_bwd_scan(
        jnp.asarray(a["gx"], jdt), jnp.asarray(a["hprev"], jdt), jnp.asarray(a["dout"]),
        jnp.asarray(a["lengths"]), jnp.asarray(a["w_hh"], jdt),
        jnp.asarray(a["b_hh"]), jnp.asarray(a["b_ih"]), jnp.asarray(a["dh_last"]),
        reverse=reverse, interpret=True,
    )
    before = gru_cuda.gru_bwd_scan.launches
    got = gru_cuda.gru_bwd_scan(
        torch.from_numpy(a["gx"]).to(tdt), torch.from_numpy(a["hprev"]).to(tdt),
        torch.from_numpy(a["dout"]), torch.from_numpy(a["lengths"]),
        torch.from_numpy(a["w_hh"]).to(tdt), torch.from_numpy(a["b_ih"]),
        torch.from_numpy(a["b_hh"]), torch.from_numpy(a["dh_last"]), reverse=reverse,
    )
    # a CPU tensor runs the plain version: no kernel launch is counted
    assert gru_cuda.gru_bwd_scan.launches == before
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    for name, g, r in zip(("dgx", "dghn", "dh0"), got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol, rtol=0,
                                   err_msg=name)
    # steps past a row's length give exact zeros and pass dL/dh through
    pad = np.arange(t)[:, None] >= a["lengths"][None, :]
    for g in got[:2]:
        assert float(np.abs(g.numpy()[pad]).max(initial=0.0)) == 0.0
    for row, n in enumerate(lengths):
        if n == 0:
            np.testing.assert_array_equal(got[2][row].numpy(), a["dh_last"][row])


def _weights(rng, d_in, hidden, scale=0.3):
    return [
        (rng.normal(size=shape) * scale).astype(np.float32)
        for shape in ((d_in, 3 * hidden), (hidden, 3 * hidden), (3 * hidden,),
                      (3 * hidden,))
    ]


def _layer_case(bidi, lens, seed):
    rng = np.random.default_rng(seed)
    t, d_in, hidden = max(lens), 10, 8
    b = len(lens)
    x = rng.normal(size=(t, b, d_in)).astype(np.float32)
    fwd = _weights(rng, d_in, hidden)
    bwd = _weights(rng, d_in, hidden) if bidi else None
    r_out = rng.normal(size=(t, b, hidden)).astype(np.float32)
    r_hl = rng.normal(size=(2 if bidi else 1, b, hidden)).astype(np.float32)
    return x, np.asarray(lens, np.int32), fwd, bwd, r_out, r_hl


def _jax_grads(x, lens, fwd, bwd, r_out, r_hl, impl="pallas"):
    jw = [jrnn.GRUWeights(*map(jnp.asarray, w)) for w in (fwd, bwd) if w is not None]

    def loss(x, *ws):
        out, hl = jrnn.gru_layer(x, jnp.asarray(lens), ws[0],
                                 ws[1] if len(ws) > 1 else None, impl=impl)
        return jnp.sum(out * r_out) + jnp.sum(hl * r_hl)

    grads = jax.grad(loss, argnums=tuple(range(1 + len(jw))))(jnp.asarray(x), *jw)
    return [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


def _torch_leaves(x, fwd, bwd):
    leaves = [torch.from_numpy(x).requires_grad_(True)]
    for w in (fwd, bwd):
        if w is not None:
            leaves += [torch.from_numpy(a).requires_grad_(True) for a in w]
    return leaves


def _torch_grads(run, x, lens, fwd, bwd, r_out, r_hl):
    leaves = _torch_leaves(x, fwd, bwd)
    out, hl = run(leaves[0], torch.from_numpy(lens), trnn.GRUWeights(*leaves[1:5]),
                  trnn.GRUWeights(*leaves[5:]) if bwd is not None else None)
    loss = (out * torch.from_numpy(r_out)).sum() + (hl * torch.from_numpy(r_hl)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)], out, hl


def _through_plain_recurrence(x, lens, fwd, bwd):
    """The layer as plain differentiable tensor ops (no autograd.Function)."""
    lens = lens.to(torch.int32)
    if bwd is None:
        h0 = torch.zeros((x.shape[1], fwd.w_hh.shape[0]))
        out, hl = gru_cuda.gru_scan_plain(x @ fwd.w_ih, lens, fwd.w_hh, fwd.b_ih,
                                          fwd.b_hh, h0)
        return out, hl[None]
    out_f, out_b, hl_f, hl_b = gru_cuda.gru_bidi_fused_plain(
        x, lens, fwd.w_ih, bwd.w_ih, fwd.w_hh, bwd.w_hh,
        fwd.b_ih, bwd.b_ih, fwd.b_hh, bwd.b_hh)
    return out_f + out_b, torch.stack([hl_f, hl_b])


@pytest.mark.parametrize("impl", ["auto", "plain"])
@pytest.mark.parametrize(
    "bidi,lens",
    [(True, [13, 13, 13]), (True, [13, 7, 4]), (False, [11, 5]), (False, [6, 0, 6])],
)
def test_gru_layer_grads_match_jax_and_autograd(bidi, lens, impl):
    """x and every weight: the Function's backward against jax.grad through
    the JAX custom VJP, and against torch autograd through the plain
    recurrence; the Function leaves the forward values as they are."""
    case = _layer_case(bidi, lens, seed=len(lens) + bidi)
    ref = _jax_grads(*case)
    got, out, hl = _torch_grads(
        lambda x, l, f, b: trnn.gru_layer(x, l, f, b, impl=impl), *case)
    auto, out_p, hl_p = _torch_grads(_through_plain_recurrence, *case)
    assert len(got) == len(ref) == (9 if bidi else 5)
    for g, r, a in zip(got, ref, auto):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=GRAD_TOL, atol=GRAD_TOL)
        np.testing.assert_allclose(g, a, rtol=F32_ATOL, atol=F32_ATOL)
    np.testing.assert_array_equal(out.detach().numpy(), out_p.detach().numpy())
    np.testing.assert_array_equal(hl.detach().numpy(), hl_p.detach().numpy())


def test_gru_layer_bf16_grads_close_to_jax():
    """The dispatch training takes under mixed precision: float32 x, bf16
    weights cast inside the graph, float32 gradients back at the masters.
    Both packages round the same streams to bf16; a gradient of order 1-10
    may differ by a few bf16 ulps of its largest terms."""
    x, lens, fwd, bwd, r_out, r_hl = _layer_case(True, [13, 7, 4], seed=5)

    def jloss(x, f, b):
        cast = lambda w: w._replace(w_ih=w.w_ih.astype(jnp.bfloat16),  # noqa: E731
                                    w_hh=w.w_hh.astype(jnp.bfloat16))
        out, hl = jrnn.gru_layer(x, jnp.asarray(lens), cast(f), cast(b), impl="pallas")
        return jnp.sum(out * r_out) + jnp.sum(hl * r_hl)

    jf, jb = (jrnn.GRUWeights(*map(jnp.asarray, w)) for w in (fwd, bwd))
    ref = [np.asarray(g) for g in jax.tree_util.tree_leaves(
        jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jf, jb))]

    def run(x, l, f, b):
        cast = lambda w: w._replace(w_ih=w.w_ih.to(torch.bfloat16),  # noqa: E731
                                    w_hh=w.w_hh.to(torch.bfloat16))
        return trnn.gru_layer(x, l, cast(f), cast(b))

    got, _, _ = _torch_grads(run, x, lens, fwd, bwd, r_out, r_hl)
    for g, r in zip(got, ref):
        assert g.dtype == np.float32
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, atol=3e-2 * scale, rtol=0)


def test_hprev_is_the_output_shifted_in_chain_order():
    """The walk's hprev: zeros at the chain start, then the output stream
    one step behind (forward chain) or ahead (reverse-time chain)."""
    seen = {}
    orig = gru_cuda.gru_bwd_scan_plain

    def spy(gx, hprev, dout, lengths, *rest, reverse=True):
        seen[reverse] = hprev.clone()
        return orig(gx, hprev, dout, lengths, *rest, reverse=reverse)

    x, lens, fwd, bwd, r_out, r_hl = _layer_case(True, [7, 7], seed=3)
    leaves = _torch_leaves(x, fwd, bwd)
    f, b = trnn.GRUWeights(*leaves[1:5]), trnn.GRUWeights(*leaves[5:])
    gru_cuda.gru_bwd_scan_plain = spy
    try:
        out, _ = trnn.gru_layer(leaves[0], torch.from_numpy(lens), f, b, impl="plain")
        out.sum().backward()
    finally:
        gru_cuda.gru_bwd_scan_plain = orig
    out_f, out_b, _, _ = gru_cuda.gru_bidi_fused_plain(
        leaves[0].detach(), torch.from_numpy(lens), f.w_ih.detach(), b.w_ih.detach(),
        f.w_hh.detach(), b.w_hh.detach(), f.b_ih.detach(), b.b_ih.detach(),
        f.b_hh.detach(), b.b_hh.detach())
    zeros = torch.zeros_like(out_f[:1])
    # the forward chain's backward walks in reverse, and the other way round
    torch.testing.assert_close(seen[True], torch.cat([zeros, out_f[:-1]]))
    torch.testing.assert_close(seen[False], torch.cat([out_b[1:], zeros]))


def test_bwd_wrapper_operand_checks_and_devices():
    a = _walk_inputs(0, 5, [5, 3], 8)
    bf = torch.bfloat16
    good = dict(
        gx=torch.from_numpy(a["gx"]).to(bf), hprev=torch.from_numpy(a["hprev"]).to(bf),
        dout=torch.from_numpy(a["dout"]), lengths=torch.from_numpy(a["lengths"]),
        w_hh=torch.from_numpy(a["w_hh"]).to(bf), b_ih=torch.from_numpy(a["b_ih"]),
        b_hh=torch.from_numpy(a["b_hh"]), dh_last=torch.from_numpy(a["dh_last"]),
    )
    with pytest.raises(ValueError, match="unsupported device"):
        gru_cuda.gru_bwd_scan(*(v.to("meta") for v in good.values()))
    # the checks the CUDA branch makes before it launches
    gru_cuda._check_scan_operands(good["gx"], good["lengths"], good["w_hh"],
                                  good["b_ih"], good["b_hh"], good["dh_last"])
    with pytest.raises(TypeError):  # a float32 hprev in the bf16 set: a mixed set
        gru_cuda._check_tensors("gx", {"gx": (good["gx"], (5, 2, 24), bf),
                                       "hprev": (good["hprev"].float(), (5, 2, 8), bf)},
                                float32=True)
    with pytest.raises(ValueError):
        gru_cuda._check_tensors("gx", {"gx": (good["gx"], (5, 2, 24), bf),
                                       "dout": (good["dout"][:4], (5, 2, 8),
                                                torch.float32)})


@pytest.mark.parametrize("field", [None, "gx", "hprev", "w_hh", "dout", "dh_last"])
def test_bwd_operand_sets(field):
    """The walk's CUDA branch takes the all-float32 set (what
    mixed_precision=False trains with) as well as the bf16 one; a float32
    set with one bf16 tensor is a mixed set and raises TypeError."""
    a = _walk_inputs(0, 5, [5, 3], 8)
    names = ["gx", "hprev", "dout", "lengths", "w_hh", "b_ih", "b_hh", "dh_last"]
    ops = [torch.from_numpy(a[k]) for k in names]
    if field is None:
        assert gru_cuda._check_bwd_operands(*ops) == torch.float32
        return
    i = names.index(field)
    ops[i] = ops[i].to(torch.bfloat16)
    with pytest.raises(TypeError):
        gru_cuda._check_bwd_operands(*ops)
