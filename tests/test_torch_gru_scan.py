"""The unidirectional GRU kernel module (``gru_scan``) of the PyTorch port
against the JAX package (CPU).

The kernel itself runs only on the card (chip_smoke.py checks it against
its plain version there). Here its plain version, which the wrapper runs
for CPU tensors, is held against ``pallas_gru.gru_scan(interpret=True)`` on
the same numpy-seeded inputs. Tolerances: in float32, F32_ATOL (summation
order only); with a bf16 gx and w_hh, the bf16 ``out`` within one bf16 ulp
of JAX's (both accumulate in f32; summation order can move a value across
one rounding boundary) and the f32 ``h_last`` within H_LAST_ATOL.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from danspeech_tpu.ops import rnn as jrnn
from danspeech_tpu.ops.pallas_gru import gru_scan as jgru_scan
from danspeech_tpu_torch.ops import gru_cuda
from danspeech_tpu_torch.ops import rnn as trnn

F32_ATOL = 1e-5
H_LAST_ATOL = 1e-4


def bf16_ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value's magnitude (8 significant bits)."""
    mag = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def assert_within_one_bf16_ulp(got: np.ndarray, ref: np.ndarray) -> None:
    diff = np.abs(got - ref)
    ulp = bf16_ulp(np.maximum(np.abs(got), np.abs(ref)))
    bad = diff > ulp
    assert not bad.any(), (
        f"{int(bad.sum())} values differ by more than one bf16 ulp, "
        f"max diff {float(diff.max())}"
    )


def _inputs(seed, t, lengths, hidden, carried_h0):
    rng = np.random.default_rng(seed)
    batch = len(lengths)
    gx = rng.normal(0.0, 0.8, (t, batch, 3 * hidden)).astype(np.float32)
    w_hh = rng.uniform(-0.3, 0.3, (hidden, 3 * hidden)).astype(np.float32)
    b_ih = rng.uniform(-0.3, 0.3, 3 * hidden).astype(np.float32)
    b_hh = rng.uniform(-0.3, 0.3, 3 * hidden).astype(np.float32)
    h0 = np.zeros((batch, hidden), np.float32)
    if carried_h0:
        h0 = rng.uniform(-0.9, 0.9, (batch, hidden)).astype(np.float32)
    return gx, np.asarray(lengths, np.int32), w_hh, b_ih, b_hh, h0


SHAPES = [
    (9, [9], 72),                 # B = 1 (the streaming step), H % 64 != 0
    (11, [11, 1, 6, 10, 3], 72),  # B = 5, ragged lengths including 1 and T
    (1, [1, 1], 16),
]


@pytest.mark.parametrize("t,lengths,hidden", SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("carried_h0", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_scan_matches_pallas_interpret(t, lengths, hidden, reverse,
                                             carried_h0, dtype):
    gx, lens, w_hh, b_ih, b_hh, h0 = _inputs(t + hidden, t, lengths, hidden,
                                             carried_h0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref_out, ref_h = jgru_scan(
        jnp.asarray(gx, jdt), jnp.asarray(lens), jnp.asarray(w_hh, jdt),
        jnp.asarray(b_hh), jnp.asarray(h0), reverse=reverse, interpret=True,
        b_ih=jnp.asarray(b_ih),
    )
    before = gru_cuda.gru_scan.launches
    got_out, got_h = gru_cuda.gru_scan(
        torch.from_numpy(gx).to(tdt), torch.from_numpy(lens),
        torch.from_numpy(w_hh).to(tdt), torch.from_numpy(b_ih),
        torch.from_numpy(b_hh), torch.from_numpy(h0), reverse=reverse,
    )
    # a CPU tensor runs the plain version: no kernel launch is counted
    assert gru_cuda.gru_scan.launches == before
    assert got_out.dtype == tdt and got_h.dtype == torch.float32
    ref_out = np.asarray(ref_out.astype(jnp.float32))
    ref_h = np.asarray(ref_h)
    assert tuple(got_out.shape) == ref_out.shape
    if dtype == "float32":
        np.testing.assert_allclose(got_out.numpy(), ref_out, atol=F32_ATOL, rtol=0)
        np.testing.assert_allclose(got_h.numpy(), ref_h, atol=F32_ATOL, rtol=0)
    else:
        assert_within_one_bf16_ulp(got_out.float().numpy(), ref_out)
        np.testing.assert_allclose(got_h.numpy(), ref_h, atol=H_LAST_ATOL, rtol=0)
    pad = np.arange(t)[:, None] >= lens[None, :]
    assert np.abs(got_out.float().numpy()[pad]).max(initial=0.0) == 0.0


def _scan_operands(t=4, batch=2, hidden=8):
    bf, f32 = torch.bfloat16, torch.float32
    return dict(
        gx=torch.zeros((t, batch, 3 * hidden), dtype=bf),
        lengths=torch.full((batch,), t, dtype=torch.int32),
        w_hh=torch.zeros((hidden, 3 * hidden), dtype=bf),
        b_ih=torch.zeros(3 * hidden, dtype=f32),
        b_hh=torch.zeros(3 * hidden, dtype=f32),
        h0=torch.zeros((batch, hidden), dtype=f32),
    )


@pytest.mark.parametrize(
    "field,bad,err",
    [
        # one float32 tensor in the bf16 set: mixed sets (the all-float32
        # set is test_scan_operand_sets')
        ("gx", torch.zeros((4, 2, 24), dtype=torch.float32), TypeError),
        ("w_hh", torch.zeros((8, 24), dtype=torch.float32), TypeError),
        ("h0", torch.zeros((2, 8), dtype=torch.bfloat16), TypeError),
        ("lengths", torch.full((2,), 4, dtype=torch.int64), TypeError),
        ("gx", torch.zeros((4, 2, 25), dtype=torch.bfloat16), ValueError),
        ("h0", torch.zeros((3, 8), dtype=torch.float32), ValueError),
        ("w_hh", torch.zeros((24, 8), dtype=torch.bfloat16).t(), ValueError),
        ("gx", torch.zeros((0, 2, 24), dtype=torch.bfloat16), ValueError),
    ],
)
def test_scan_operand_checks(field, bad, err):
    ops = _scan_operands()
    ops[field] = bad
    with pytest.raises(err):
        gru_cuda._check_scan_operands(**ops)
    gru_cuda._check_scan_operands(**_scan_operands())


@pytest.mark.parametrize(
    "family,field,to",
    [
        ("bf16", None, None),
        ("float32", None, None),
        # mixed sets: the float32 set with one bf16 tensor, and a float32
        # gx with bf16 weights
        ("float32", "w_hh", torch.bfloat16),
        ("float32", "h0", torch.bfloat16),
        ("float32", "b_hh", torch.bfloat16),
        ("bf16", "gx", torch.float32),
    ],
)
def test_scan_operand_sets(family, field, to):
    """gru_scan's CUDA branch (and B2's, per chain) takes the all-bf16 set
    (bf16 gx and w_hh, f32 biases and h0) or the all-float32 one, told apart
    by gx's dtype, and returns which; a mixed set raises TypeError."""
    ops = _scan_operands()
    if family == "float32":
        ops = {k: v if k == "lengths" else v.float() for k, v in ops.items()}
    if field is None:
        want = torch.bfloat16 if family == "bf16" else torch.float32
        assert gru_cuda._check_scan_operands(**ops) == want
        return
    ops[field] = ops[field].to(to)
    with pytest.raises(TypeError):
        gru_cuda._check_scan_operands(**ops)


def test_scan_wrapper_raises_off_cpu_and_cuda():
    ops = {k: v.to("meta") for k, v in _scan_operands().items()}
    with pytest.raises(ValueError):
        gru_cuda.gru_scan(**ops)


def _layer_weights(rng, d_in, hidden, dtype_np=np.float32):
    arrays = [
        rng.uniform(-0.3, 0.3, (d_in, 3 * hidden)),
        rng.uniform(-0.3, 0.3, (hidden, 3 * hidden)),
        rng.uniform(-0.3, 0.3, 3 * hidden),
        rng.uniform(-0.3, 0.3, 3 * hidden),
    ]
    return [a.astype(dtype_np) for a in arrays]


def _jw(a, dtype=jnp.float32):
    return jrnn.GRUWeights(jnp.asarray(a[0], dtype), jnp.asarray(a[1], dtype),
                           jnp.asarray(a[2]), jnp.asarray(a[3]))


def _tw(a, dtype=torch.float32):
    return trnn.GRUWeights(torch.from_numpy(a[0]).to(dtype),
                           torch.from_numpy(a[1]).to(dtype),
                           torch.from_numpy(a[2]), torch.from_numpy(a[3]))


@pytest.mark.parametrize("t_valid", [None, 7, 1])
@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_streaming_layer_f32_matches_jax(t_valid, impl):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(12, 1, 20)).astype(np.float32)
    w = _layer_weights(rng, 20, 72)
    h0 = rng.uniform(-0.5, 0.5, (1, 72)).astype(np.float32)
    ref_out, ref_h = jrnn.gru_layer_streaming(
        jnp.asarray(x), _jw(w), jnp.asarray(h0), t_valid=t_valid, impl="xla"
    )
    got_out, got_h = trnn.gru_layer_streaming(
        torch.from_numpy(x), _tw(w), torch.from_numpy(h0), t_valid=t_valid,
        impl=impl,
    )
    assert got_out.dtype == torch.float32
    np.testing.assert_allclose(got_out.numpy(), np.asarray(ref_out), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), atol=F32_ATOL, rtol=0)


def test_streaming_layer_bf16_matches_jax_pallas():
    """bf16 weights: both sides project into a bf16 gx (the CPU products
    accumulate in f32 and round once), so gx may differ by one bf16 ulp
    before the scan; outputs then agree to a few bf16 ulps."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(10, 1, 24)).astype(np.float32)
    w = _layer_weights(rng, 24, 72)
    h0 = rng.uniform(-0.5, 0.5, (1, 72)).astype(np.float32)
    ref_out, ref_h = jrnn.gru_layer_streaming(
        jnp.asarray(x), _jw(w, jnp.bfloat16), jnp.asarray(h0), t_valid=8,
        impl="pallas",
    )
    got_out, got_h = trnn.gru_layer_streaming(
        torch.from_numpy(x), _tw(w, torch.bfloat16), torch.from_numpy(h0),
        t_valid=8,
    )
    np.testing.assert_allclose(got_out.numpy(), np.asarray(ref_out), atol=2e-2, rtol=0)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), atol=2e-2, rtol=0)
    assert np.abs(got_out.numpy()[8:]).max() == 0.0


def test_streaming_layer_rejects_unknown_impl():
    rng = np.random.default_rng(0)
    w = _tw(_layer_weights(rng, 4, 8))
    with pytest.raises(ValueError):
        trnn.gru_layer_streaming(torch.zeros(3, 1, 4), w, torch.zeros(1, 8),
                                 impl="xla")


def test_transposed_copy_is_kept_per_tensor_and_version():
    """The persistent routes read rows of w_hh^T: one copy per weight tensor,
    made again when the tensor is written in place, dropped with it."""
    w = torch.randn(4, 12)
    wt = gru_cuda.transposed(w)
    assert torch.equal(wt, w.t()) and wt.is_contiguous()
    assert gru_cuda.transposed(w) is wt
    w.mul_(2.0)  # an optimizer step bumps the version counter
    wt2 = gru_cuda.transposed(w)
    assert wt2 is not wt and torch.equal(wt2, w.t())
    other = torch.randn(4, 12)
    assert torch.equal(gru_cuda.transposed(other), other.t())
    key = id(other)
    del other
    assert key not in gru_cuda._transposes
    with torch.inference_mode():
        frozen = torch.randn(3, 6)  # an inference tensor keeps no version
    assert torch.equal(gru_cuda.transposed(frozen), frozen.t())
    assert gru_cuda.transposed(frozen) is not gru_cuda.transposed(frozen)
