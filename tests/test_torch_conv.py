"""Conv-stack ops of the PyTorch port against the JAX package (CPU).

Tolerances: float32 ATOL = 1e-4 on activations in [0, 20] (convolution
sums of up to 451 or 7392 terms taken in another order: the JAX package
runs the first layer as a space-to-depth conv). In bf16 the port's
convolution rounds its output to bf16 where JAX keeps f32, so BF16_TOL is
about two bf16 ulps relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from danspeech_tpu.models import deepspeech as jds
from danspeech_tpu.models.config import CONV_SPECS
from danspeech_tpu.models.config import DeepSpeechConfig as JConfig
from danspeech_tpu.ops import conv as jconv
from danspeech_tpu_torch.models import deepspeech as tds
from danspeech_tpu_torch.models.config import DeepSpeechConfig as TConfig
from danspeech_tpu_torch.ops import conv as tconv

ATOL = 1e-4
BF16_TOL = 1e-2


def _conv_params(rng, spec):
    kf, kt = spec["kernel"]
    o, i = spec["out"], spec["in"]
    bound = 1.0 / np.sqrt(i * kf * kt)
    arrays = [
        rng.uniform(-bound, bound, (o, i, kf, kt)),
        rng.uniform(-bound, bound, o),
        rng.normal(1.0, 0.2, o),
        rng.normal(0.0, 0.2, o),
        rng.normal(0.0, 0.5, o),
        rng.uniform(0.5, 2.0, o),
    ]
    arrays = [a.astype(np.float32) for a in arrays]
    return (
        jconv.ConvParams(*[jnp.asarray(a) for a in arrays]),
        tconv.ConvParams(*[torch.from_numpy(a) for a in arrays]),
    )


def _inputs(rng, layer, n=3, f=161, t=57):
    c = CONV_SPECS[layer]["in"]
    x = rng.normal(size=(n, c, f, t)).astype(np.float32)
    if layer:
        x = np.clip(x * 5.0, 0.0, 20.0)  # hardtanh range, as a block emits
    lengths = np.array([t, t // 2, 3][:n], np.int32)
    return x, lengths


@pytest.mark.parametrize("layer", [0, 1, 2])
@pytest.mark.parametrize("folded", [True, False])
def test_conv_block_matches_jax(layer, folded):
    rng = np.random.default_rng(layer)
    spec = CONV_SPECS[layer]
    jp, tp = _conv_params(rng, spec)
    x, lengths = _inputs(rng, layer)
    st, pd = spec["stride"], spec["padding"]
    kt = spec["kernel"][1]
    out_len = tconv.conv_out_length(lengths, kt, st[1], pd[1])
    ref = jconv.conv_block(jnp.asarray(x), jp, jnp.asarray(out_len), st, pd, folded=folded)
    got = tconv.conv_block(torch.from_numpy(x), tp, torch.from_numpy(out_len), st, pd,
                           folded=folded)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("layer", [0, 2])
def test_conv_block_bf16_matches_jax(layer):
    rng = np.random.default_rng(10 + layer)
    spec = CONV_SPECS[layer]
    jp, tp = _conv_params(rng, spec)
    jp = jp._replace(weight=jp.weight.astype(jnp.bfloat16))
    tp = tp._replace(weight=tp.weight.to(torch.bfloat16))
    x, lengths = _inputs(rng, layer)
    st, pd = spec["stride"], spec["padding"]
    out_len = tconv.conv_out_length(lengths, spec["kernel"][1], st[1], pd[1])
    ref = np.asarray(jconv.conv_block(jnp.asarray(x), jp, jnp.asarray(out_len), st, pd))
    got = tconv.conv_block(torch.from_numpy(x), tp, torch.from_numpy(out_len), st, pd)
    np.testing.assert_allclose(got.numpy(), ref, atol=BF16_TOL, rtol=BF16_TOL)


def test_fold_bn_into_conv_matches_jax():
    rng = np.random.default_rng(4)
    jp, tp = _conv_params(rng, CONV_SPECS[1])
    jw, jb = jconv.fold_bn_into_conv(jp)
    tw, tb = tconv.fold_bn_into_conv(tp)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("conv_layers", [1, 2, 3])
def test_get_seq_lens_matches_jax(conv_layers):
    lengths = np.array([1, 2, 11, 100, 101, 801, 1601], np.int32)
    jcfg = JConfig(conv_layers=conv_layers)
    tcfg = TConfig(conv_layers=conv_layers)
    ref = np.asarray(jds.get_seq_lens(jcfg, jnp.asarray(lengths)))
    got = tds.get_seq_lens(tcfg, torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert tcfg.rnn_input_size == jcfg.rnn_input_size


def test_lookahead_and_hardtanh_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(13, 2, 8)).astype(np.float32) * 10
    w = rng.normal(size=(8, 4)).astype(np.float32)
    ref = jconv.hardtanh(jconv.lookahead(jnp.asarray(x), jconv.LookaheadParams(jnp.asarray(w))))
    got = tconv.hardtanh(tconv.lookahead(torch.from_numpy(x),
                                         tconv.LookaheadParams(torch.from_numpy(w))))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-6)


def test_time_mask_and_batchnorm_match_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 4, 5, 9)).astype(np.float32)
    lengths = np.array([9, 4, 0], np.int32)
    stats = [rng.uniform(0.5, 2.0, 4).astype(np.float32) for _ in range(4)]
    ref = jconv.time_mask(
        jconv.batchnorm_eval(jnp.asarray(x), *[jnp.asarray(s) for s in stats]),
        jnp.asarray(lengths),
    )
    got = tconv.time_mask(
        tconv.batchnorm_eval(torch.from_numpy(x), *[torch.from_numpy(s) for s in stats]),
        torch.from_numpy(lengths),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
