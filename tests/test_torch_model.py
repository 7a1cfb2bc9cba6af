"""DeepSpeech2 model of the PyTorch port against the JAX package (CPU):
seeded init, the weight bridge, .dsz checkpoints and the forward pass.

Weights cross as the JAX ``state_dict_from_params`` numpy dict. Tolerances
on softmax probabilities (values of order 1/33): F32_ATOL in float32
(summation order only); BF16_ATOL with bf16 matmul weights, where the
port's bf16 convolutions round their outputs to bf16 and JAX keeps them in
f32 before the GRU input is rounded to bf16 anyway.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from danspeech_tpu.models import DeepSpeechModel as JModel
from danspeech_tpu.models import checkpoint as jckpt
from danspeech_tpu.models import deepspeech as jds
from danspeech_tpu.models.config import DeepSpeechConfig as JConfig
from danspeech_tpu_torch.models import DeepSpeechModel as TModel
from danspeech_tpu_torch.models import checkpoint as tckpt
from danspeech_tpu_torch.models import deepspeech as tds
from danspeech_tpu_torch.models.config import DeepSpeechConfig as TConfig

F32_ATOL = 1e-5
BF16_ATOL = 1e-2

SMALL = dict(model_name="small", rnn_hidden_size=32, rnn_layers=2, conv_layers=3)


def _randomize_bn(sd, seed=7):
    """Non-trivial BN statistics (init leaves them at identity)."""
    rng = np.random.default_rng(seed)
    sd = dict(sd)
    for k in list(sd):
        n = sd[k].shape
        if k.endswith("running_mean"):
            sd[k] = rng.normal(0.0, 0.3, n).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, n).astype(np.float32)
        elif ("batch_norm" in k or "seq_module.1." in k or "seq_module.4." in k
              or "seq_module.7." in k or "fc.0.module.0." in k) and k.endswith("weight"):
            sd[k] = rng.normal(1.0, 0.2, n).astype(np.float32)
    return sd


def _models(seed=0, **cfg):
    jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
    sd = _randomize_bn(jckpt.state_dict_from_params(jds.init_params(jcfg, seed), jcfg))
    jparams = jckpt.params_from_state_dict(sd, jcfg)
    tparams = tckpt.params_from_state_dict(sd, tcfg)
    return jcfg, jparams, tcfg, tparams


def _spect(seed, n=3, t=120):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 1, 161, t)).astype(np.float32)
    lengths = np.array([t, t - 37, 9][:n], np.int32)
    x *= (np.arange(t)[None, :] < lengths[:, None])[:, None, None, :]
    return x, lengths


@pytest.mark.parametrize(
    "cfg",
    [
        dict(conv_layers=3, rnn_hidden_size=24, rnn_layers=3),
        dict(conv_layers=1, rnn_hidden_size=16, rnn_layers=1),
        dict(conv_layers=2, rnn_hidden_size=16, rnn_layers=2, bidirectional=False),
    ],
)
def test_init_params_bit_identical(cfg):
    jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
    ref = jckpt.state_dict_from_params(jds.init_params(jcfg, seed=5), jcfg)
    got = tckpt.state_dict_from_params(tds.init_params(tcfg, seed=5), tcfg)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    assert tds.num_params(tds.init_params(tcfg, seed=5)) == jds.num_params(
        jds.init_params(jcfg, seed=5)
    )


def test_state_dict_round_trip():
    jcfg, jparams, tcfg, tparams = _models(**SMALL)
    ref = jckpt.state_dict_from_params(jparams, jcfg)
    got = tckpt.state_dict_from_params(tparams, tcfg)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)


def test_dsz_checkpoints_cross_both_ways(tmp_path):
    cfg = dict(SMALL, bidirectional=False)
    jcfg, jparams, tcfg, tparams = _models(**cfg)
    jpath, tpath = str(tmp_path / "j.dsz"), str(tmp_path / "t.dsz")
    JModel(jcfg, jparams).save(jpath)
    TModel(tcfg, tparams).save(tpath)
    loaded = TModel.load_model(jpath)
    assert loaded.config.to_dict() == tcfg.to_dict()
    j_back = JModel.load_model(tpath)
    ref = jckpt.state_dict_from_params(jparams, jcfg)
    for sd in (
        tckpt.state_dict_from_params(loaded.params, loaded.config),
        jckpt.state_dict_from_params(j_back.params, j_back.config),
    ):
        for k in ref:
            np.testing.assert_array_equal(np.asarray(sd[k]), np.asarray(ref[k]), err_msg=k)
    with pytest.raises(NotImplementedError):
        TModel.load_model(str(tmp_path / "x.pth"))


@pytest.mark.parametrize("rnn_impl", ["xla", "pallas"])
def test_forward_f32_matches_jax(rnn_impl):
    jcfg, jparams, tcfg, tparams = _models(**SMALL)
    x, lengths = _spect(0)
    ref, ref_len = jds.forward(jparams, jcfg, jnp.asarray(x), jnp.asarray(lengths),
                               rnn_impl=rnn_impl)
    got, got_len = tds.forward(tparams, tcfg, torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_ATOL, rtol=0)


def test_forward_unidirectional_lookahead_matches_jax():
    jcfg, jparams, tcfg, tparams = _models(**dict(SMALL, bidirectional=False))
    x, lengths = _spect(1)
    ref, _ = jds.forward(jparams, jcfg, jnp.asarray(x), jnp.asarray(lengths), rnn_impl="xla")
    got, _ = tds.forward(tparams, tcfg, torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_ATOL, rtol=0)


def test_forward_bf16_matches_jax_pallas():
    jcfg, jparams, tcfg, tparams = _models(**SMALL)
    x, lengths = _spect(2)
    ref, _ = jds.forward(jds.cast_matmul_weights(jparams), jcfg, jnp.asarray(x),
                         jnp.asarray(lengths), rnn_impl="pallas")
    tp = tds.cast_matmul_weights(tparams)
    assert tp["rnns"][0]["fwd"].w_hh.dtype == torch.bfloat16
    assert tp["rnns"][0]["fwd"].b_hh.dtype == torch.float32
    got, _ = tds.forward(tp, tcfg, torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=BF16_ATOL, rtol=0)
    plain, _ = tds.forward(tp, tcfg, torch.from_numpy(x), torch.from_numpy(lengths),
                           rnn_impl="plain")
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_non_gru_models_raise():
    """LSTM and tanh-RNN models build (their own weights class, 4 and 1
    gates); what still raises for them is streaming, which is GRU-only in
    both packages."""
    from danspeech_tpu_torch.models import streaming as tstream
    from danspeech_tpu_torch.ops import rnn as trnn

    for rnn_type, cls, gates in (("lstm", trnn.LSTMWeights, 4), ("rnn", trnn.RNNWeights, 1)):
        cfg = TConfig(rnn_type=rnn_type, rnn_hidden_size=8, rnn_layers=1, conv_layers=2)
        fwd = tds.init_params(cfg)["rnns"][0]["fwd"]
        assert type(fwd) is cls and fwd.w_hh.shape == (8, gates * 8)
        with pytest.raises(NotImplementedError, match="GRU models only"):
            tstream.require_gru(cfg)
    tstream.require_gru(TConfig(rnn_hidden_size=8, rnn_layers=1))
