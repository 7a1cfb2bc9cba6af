"""The port's conv layouts (``conv2d_banded_cin1``, ``conv2d_s2d_cin1``,
``conv2d_s2d_freq``) against their JAX namesakes and against the port's
direct ``conv2d`` (CPU).

Inputs are seeded numpy normals at the flagship's kernels, strides and
paddings (``danspeech_tpu/models/config.py`` CONV_SPECS) on small grids,
odd and even, so that JAX's one-more pad on the high sides (the phases'
equal lengths) is taken both ways. Float32: F32_ATOL = 1e-5 on outputs of
up to about 6 (sums of up to 7392 products in another order; the largest
difference seen on the CPU is 5.2e-6). bf16: both packages round the
operands to bf16, and the port's product rounds its output to bf16 where
JAX keeps float32 (ROADMAP C5), so BF16_TOL = 1e-2 relative to the
output's largest magnitude, as for ``conv_block`` (2.6e-3 seen).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from danspeech_tpu.ops import conv as jconv
from danspeech_tpu_torch.ops import conv as tconv

F32_ATOL = 1e-5
BF16_TOL = 1e-2

FIRST = dict(kernel=(41, 11), stride=(2, 2), padding=(20, 5), cin=1, cout=32)
LATER = dict(kernel=(21, 11), stride=(2, 1), padding=(10, 5), cin=32, cout=32)
LAST = dict(kernel=(21, 11), stride=(2, 1), padding=(10, 5), cin=32, cout=96)


def _inputs(seed, spec, b, f, t):
    rng = np.random.default_rng(seed)
    kf, kt = spec["kernel"]
    x = rng.normal(size=(b, spec["cin"], f, t)).astype(np.float32)
    w = (rng.normal(size=(spec["cout"], spec["cin"], kf, kt))
         / np.sqrt(spec["cin"] * kf * kt)).astype(np.float32)
    bias = rng.normal(size=spec["cout"]).astype(np.float32)
    return x, w, bias


def _both(name, spec, x, w, bias, dtype):
    jfn, tfn = getattr(jconv, name), getattr(tconv, name)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = np.asarray(jfn(jnp.asarray(x), jnp.asarray(w).astype(jd), jnp.asarray(bias),
                         spec["stride"], spec["padding"]))
    got = tfn(torch.from_numpy(x), torch.from_numpy(w).to(dtype), torch.from_numpy(bias),
              spec["stride"], spec["padding"])
    assert got.dtype == torch.float32
    assert tuple(got.shape) == ref.shape
    return got.numpy(), ref


def _check(got, ref, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=0)
    else:
        assert float(np.abs(got - ref).max()) <= BF16_TOL * float(np.abs(ref).max())


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("f,t", [(161, 57), (160, 56), (81, 33)])
def test_s2d_cin1_matches_jax(f, t, dtype):
    got, ref = _both("conv2d_s2d_cin1", FIRST, *_inputs(0, FIRST, 2, f, t), dtype)
    _check(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("spec,f,t", [(LATER, 81, 29), (LATER, 80, 30), (LAST, 41, 29),
                                      (dict(LATER, cin=3, cout=8), 33, 17)],
                         ids=["conv2-odd", "conv2-even", "conv3", "narrow"])
def test_s2d_freq_matches_jax(spec, f, t, dtype):
    got, ref = _both("conv2d_s2d_freq", spec, *_inputs(1, spec, 2, f, t), dtype)
    _check(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("spec,f,t", [(FIRST, 161, 57), (FIRST, 160, 40),
                                      (dict(FIRST, kernel=(11, 7), stride=(2, 1),
                                            padding=(5, 3), cout=16), 80, 50)],
                         ids=["conv1-odd", "conv1-even", "stride21"])
def test_banded_cin1_matches_jax(spec, f, t, dtype):
    got, ref = _both("conv2d_banded_cin1", spec, *_inputs(2, spec, 2, f, t), dtype)
    _check(got, ref, dtype)


@pytest.mark.parametrize("name,spec", [("conv2d_banded_cin1", FIRST),
                                       ("conv2d_s2d_cin1", FIRST),
                                       ("conv2d_s2d_freq", LAST)])
def test_layouts_equal_the_direct_conv(name, spec):
    """Each layout computes the port's ``conv2d`` (float32, F32_ATOL)."""
    x, w, bias = (torch.from_numpy(a) for a in _inputs(3, spec, 2, 81, 31))
    got = getattr(tconv, name)(x, w, bias, spec["stride"], spec["padding"])
    ref = tconv.conv2d(x, w, bias, spec["stride"], spec["padding"])
    torch.testing.assert_close(got, ref, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("name,stride,cin", [("conv2d_banded_cin1", (2, 2), 2),
                                             ("conv2d_s2d_cin1", (2, 1), 1),
                                             ("conv2d_s2d_cin1", (2, 2), 2),
                                             ("conv2d_s2d_freq", (2, 2), 1)])
def test_layouts_refuse_shapes_they_do_not_cover(name, stride, cin):
    x, w = torch.zeros(1, cin, 41, 21), torch.zeros(4, cin, 11, 5)
    with pytest.raises(ValueError):
        getattr(tconv, name)(x, w, None, stride, (5, 2))


def test_conv_block_keeps_the_direct_conv(monkeypatch):
    """``conv_block`` runs ``conv2d`` for the first conv too (the JAX one
    takes the space-to-depth layout there)."""
    calls = []
    monkeypatch.setattr(tconv, "conv2d_s2d_cin1", lambda *a: calls.append("s2d"))
    x, w, bias = (torch.from_numpy(a) for a in _inputs(4, FIRST, 1, 41, 21))
    o = FIRST["cout"]
    p = tconv.ConvParams(w, bias, torch.ones(o), torch.zeros(o), torch.zeros(o), torch.ones(o))
    out = tconv.conv_block(x, p, torch.tensor([11]), FIRST["stride"], FIRST["padding"])
    assert not calls and out.shape == (1, o, 21, 11)
