"""``gru_scan_bidi`` of the PyTorch port against the JAX package (CPU).

The CUDA kernel runs only on the card (chip_smoke.py holds it against its
plain version there). Here the plain version, which the wrapper runs for
CPU tensors, is held against JAX ``gru_scan_bidi(interpret=True)``, and
``gru_layer`` on the two routes that reach it (concatenated directions, a
carried h0) against the JAX layer. Tolerances: float32 F32_ATOL (summation
order); with bf16 streams and weights BF16_OUT_ATOL on the bf16 outputs (two
bf16 ulps at |h| < 1) and H_LAST_ATOL on the float32 h_last.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from danspeech_tpu.ops import rnn as jrnn
from danspeech_tpu.ops.pallas_gru import gru_scan_bidi as j_gru_scan_bidi
from danspeech_tpu_torch.ops import gru_cuda
from danspeech_tpu_torch.ops import rnn as trnn

F32_ATOL = 1e-5
BF16_OUT_ATOL = 8e-3
H_LAST_ATOL = 1e-4


def _inputs(seed, t, lengths, hidden):
    rng = np.random.default_rng(seed)
    b = len(lengths)

    def f32(*shape, scale=0.3):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return dict(
        gx_f=f32(t, b, 3 * hidden, scale=0.5), gx_b=f32(t, b, 3 * hidden, scale=0.5),
        lengths=np.asarray(lengths, np.int32),
        w_hh_f=f32(hidden, 3 * hidden), w_hh_b=f32(hidden, 3 * hidden),
        b_ih_f=f32(3 * hidden), b_ih_b=f32(3 * hidden),
        b_hh_f=f32(3 * hidden), b_hh_b=f32(3 * hidden),
        h0_f=f32(b, hidden, scale=0.5), h0_b=f32(b, hidden, scale=0.5),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "t,lengths,hidden,unroll",
    [
        (19, [19, 11, 6, 2], 16, 4),  # T not a multiple of the JAX unroll
        (13, [13, 0, 1, 7, 12], 24, 1),
        (1, [1], 8, 1),
    ],
)
def test_plain_scan_bidi_matches_pallas_interpret(t, lengths, hidden, unroll, dtype):
    a = _inputs(t, t, lengths, hidden)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    seq = ("gx_f", "gx_b", "w_hh_f", "w_hh_b")
    j = {k: jnp.asarray(v, jdt if k in seq else None) for k, v in a.items()}
    ref = j_gru_scan_bidi(
        j["gx_f"], j["gx_b"], j["lengths"], j["w_hh_f"], j["w_hh_b"],
        j["b_hh_f"], j["b_hh_b"], j["h0_f"], j["h0_b"],
        interpret=True, unroll=unroll, b_ih_f=j["b_ih_f"], b_ih_b=j["b_ih_b"],
    )
    p = {k: torch.from_numpy(v).to(tdt) if k in seq else torch.from_numpy(v)
         for k, v in a.items()}
    before = gru_cuda.gru_scan_bidi.launches
    got = gru_cuda.gru_scan_bidi(
        p["gx_f"], p["gx_b"], p["lengths"], p["w_hh_f"], p["w_hh_b"],
        p["b_ih_f"], p["b_ih_b"], p["b_hh_f"], p["b_hh_b"], p["h0_f"], p["h0_b"],
    )
    # CPU tensors run the plain version: no kernel launch is counted
    assert gru_cuda.gru_scan_bidi.launches == before
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == (tdt if i < 2 else torch.float32)
        assert tuple(g.shape) == r.shape
        if dtype == "float32":
            atol = F32_ATOL
        else:
            atol = BF16_OUT_ATOL if i < 2 else H_LAST_ATOL
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r.astype(jnp.float32)),
                                   atol=atol, rtol=0)
    pad = np.arange(t)[:, None] >= a["lengths"][None, :]
    for out in got[:2]:
        assert float(np.abs(out.float().numpy()[pad]).max(initial=0.0)) == 0.0
    # a row of length 0 never leaves its h0, in either direction
    for row, n in enumerate(lengths):
        if n == 0:
            np.testing.assert_array_equal(got[2][row].numpy(), a["h0_f"][row])
            np.testing.assert_array_equal(got[3][row].numpy(), a["h0_b"][row])


def _weights(rng, d_in, hidden, scale=0.3):
    return [
        rng.uniform(-scale, scale, shape).astype(np.float32)
        for shape in ((d_in, 3 * hidden), (hidden, 3 * hidden), (3 * hidden,),
                      (3 * hidden,))
    ]


@pytest.mark.parametrize("impl", ["auto", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["concat", "carried_h0", "concat_carried_h0"])
def test_gru_layer_scan_bidi_routes_match_jax(mode, dtype, impl):
    rng = np.random.default_rng(len(mode))
    t, lens, d_in, hidden = 11, np.asarray([11, 4, 1], np.int32), 12, 8
    x = rng.normal(size=(t, len(lens), d_in)).astype(np.float32)
    f, b = _weights(rng, d_in, hidden), _weights(rng, d_in, hidden)
    h0 = None
    if "carried_h0" in mode:
        h0 = (rng.normal(size=(2, len(lens), hidden)) * 0.5).astype(np.float32)
    kw = dict(sum_directions="concat" not in mode)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16

    def jw(w):
        return jrnn.GRUWeights(jnp.asarray(w[0], jdt), jnp.asarray(w[1], jdt),
                               jnp.asarray(w[2]), jnp.asarray(w[3]))

    def tw(w):
        return trnn.GRUWeights(torch.from_numpy(w[0]).to(tdt),
                               torch.from_numpy(w[1]).to(tdt),
                               torch.from_numpy(w[2]), torch.from_numpy(w[3]))

    ref_out, ref_h = jrnn.gru_layer(
        jnp.asarray(x), jnp.asarray(lens), jw(f), jw(b),
        h0=None if h0 is None else jnp.asarray(h0), impl="pallas", **kw)
    calls = []
    name = "gru_scan_bidi" if impl == "auto" else "gru_scan_bidi_plain"
    orig = getattr(gru_cuda, name)

    def counted(*args):
        calls.append(name)
        return orig(*args)

    setattr(gru_cuda, name, counted)
    try:
        got_out, got_h = trnn.gru_layer(
            torch.from_numpy(x), torch.from_numpy(lens), tw(f), tw(b),
            h0=None if h0 is None else torch.from_numpy(h0), impl=impl, **kw)
    finally:
        setattr(gru_cuda, name, orig)
    assert calls == [name]  # one call for both directions
    assert got_out.dtype == torch.float32
    assert tuple(got_out.shape) == (t, len(lens), hidden * (1 if kw["sum_directions"] else 2))
    # a summed output holds two bf16 roundings. At these widths the JAX layer
    # takes its fused kernel, which keeps the projection in float32, where
    # this route (as the JAX package's own beyond 72 MB of weights) streams
    # it in bf16: the float32 h_last then differs like a bf16 output
    out_atol = F32_ATOL if dtype == "float32" else 2 * BF16_OUT_ATOL
    np.testing.assert_allclose(got_out.numpy(), np.asarray(ref_out), atol=out_atol, rtol=0)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h),
                               atol=F32_ATOL if dtype == "float32" else BF16_OUT_ATOL,
                               rtol=0)


def test_scan_bidi_wrapper_rejects_other_devices():
    a = _inputs(0, 3, [3, 2], 8)
    meta = [torch.from_numpy(v).to("meta") for v in a.values()]
    with pytest.raises(ValueError, match="unsupported device"):
        gru_cuda.gru_scan_bidi(*meta)


def test_forward_only_routes_are_differentiable_on_cpu():
    """On the CPU the plain version is plain tensor ops, so autograd reaches
    the concatenated route too (on CUDA it raises: no backward kernel)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(5, 2, 6)).astype(np.float32)).requires_grad_()
    f = trnn.GRUWeights(*(torch.from_numpy(w).requires_grad_() for w in _weights(rng, 6, 4)))
    b = trnn.GRUWeights(*(torch.from_numpy(w).requires_grad_() for w in _weights(rng, 6, 4)))
    out, _ = trnn.gru_layer(x, torch.tensor([5, 3]), f, b, sum_directions=False)
    out.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert float(b.w_hh.grad.abs().max()) > 0


@pytest.mark.parametrize("design", ["persistent", "step"])
def test_scan_bidi_design_runs_the_plain_version_on_the_cpu(design):
    """``design`` picks the kernel on the card (one persistent launch of
    gru_scan's kernel over both chains, or the step kernel); CPU tensors run
    the plain version whatever it says: exactly the plain result, and JAX's
    ``gru_scan_bidi(interpret=True)`` within BF16_OUT_ATOL / H_LAST_ATOL."""
    t, lengths, hidden = 13, [13, 0, 1, 7, 12], 24
    a = _inputs(41, t, lengths, hidden)
    seq = ("gx_f", "gx_b", "w_hh_f", "w_hh_b")
    p = {k: torch.from_numpy(v).to(torch.bfloat16) if k in seq else torch.from_numpy(v)
         for k, v in a.items()}
    names = ("gx_f", "gx_b", "lengths", "w_hh_f", "w_hh_b", "b_ih_f", "b_ih_b", "b_hh_f",
             "b_hh_b", "h0_f", "h0_b")
    counts = dict(gru_cuda.gru_scan_bidi.design_counts)
    got = gru_cuda.gru_scan_bidi(*(p[k] for k in names), design=design)
    assert gru_cuda.gru_scan_bidi.design_counts == counts
    for g, w in zip(got, gru_cuda.gru_scan_bidi_plain(*(p[k] for k in names))):
        assert torch.equal(g, w)
    j = {k: jnp.asarray(v, jnp.bfloat16 if k in seq else None) for k, v in a.items()}
    ref = j_gru_scan_bidi(
        j["gx_f"], j["gx_b"], j["lengths"], j["w_hh_f"], j["w_hh_b"],
        j["b_hh_f"], j["b_hh_b"], j["h0_f"], j["h0_b"],
        interpret=True, b_ih_f=j["b_ih_f"], b_ih_b=j["b_ih_b"],
    )
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r.astype(jnp.float32)),
                                   atol=BF16_OUT_ATOL if i < 2 else H_LAST_ATOL, rtol=0)
