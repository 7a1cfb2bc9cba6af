"""The port's time-sharded forward (danspeech_tpu_torch/parallel/time_shard.py)
on spawned gloo ranks on the CPU, against the JAX package's
``time_sharded_forward`` on its CPU mesh and the port's own ``forward``.
Twin of tests/test_time_shard.py.

Each world size runs every case in one spawned group; the tests assert case
by case. Top-level imports stay torch, numpy and the port.
"""

import numpy as np
import pytest
import torch

from torch_ranks import jax_model, jax_state_dict, port_model, run_ranks

ATOL, RTOL = 2e-4, 1e-3
SIZES = (1, 2, 4)

# name -> (config, T of the spectrogram, lengths): JAX's cases, plus a
# lookahead whose context spans two or more ranks' chunks
CASES = {
    "bidi_ring": (dict(rnn_hidden_size=64, rnn_layers=3, conv_layers=2), 160, [74]),
    "bidi_3conv_batch": (dict(rnn_hidden_size=48, rnn_layers=2, conv_layers=3), 192,
                         [96, 41]),
    "uni_wavefront": (dict(rnn_hidden_size=64, rnn_layers=4, conv_layers=2,
                           bidirectional=False, context=20), 160, [80]),
    "uni_length_mid_shard": (dict(rnn_hidden_size=32, rnn_layers=2, conv_layers=2,
                                  bidirectional=False, context=5), 160, [33]),
    "uni_lookahead_hops": (dict(rnn_hidden_size=32, rnn_layers=2, conv_layers=2,
                                bidirectional=False, context=20), 48, [44]),
}
LONG_CFG = dict(model_name="long", rnn_hidden_size=64, rnn_layers=2, conv_layers=2)
LONG_UNI_CFG = dict(model_name="long-uni", rnn_hidden_size=48, rnn_layers=3,
                    conv_layers=2, bidirectional=False, context=20)


def _spect(name, n):
    from danspeech_tpu_torch.parallel.time_shard import pad_time_for_mesh

    _, t, lengths = CASES[name]
    rng = np.random.default_rng(len(name))
    return pad_time_for_mesh(rng.normal(size=(len(lengths), 1, 161, t))
                             .astype(np.float32), n)


def _long_wave():
    rng = np.random.default_rng(12)
    n = int(rng.integers(8 * 16000, 12 * 16000))
    return np.clip(rng.normal(size=n) * 3000, -32768, 32767).astype(np.int16)


def _count_routes(gru_cuda):
    """Wrap the two recurrence wrappers to count the calls each route
    makes (one chain: gru_scan; both chains: gru_scan_bidi)."""
    counts = {"gru_scan": 0, "gru_scan_bidi": 0}
    for name in counts:
        inner = getattr(gru_cuda, name)

        def counted(*a, _inner=inner, _name=name, **k):
            counts[_name] += 1
            return _inner(*a, **k)

        setattr(gru_cuda, name, counted)
    return counts


def _ts_rank(rank, n, sds, long_sds, wave):
    from danspeech_tpu_torch import Recognizer
    from danspeech_tpu_torch.ops import gru_cuda
    from danspeech_tpu_torch.parallel import make_mesh, time_sharded_forward

    mesh = make_mesh(device="cpu")
    counts = _count_routes(gru_cuda)
    out = {}
    for name, (kw, _, lengths) in CASES.items():
        model = port_model(dict(kw, model_name=name), sds[name])
        for k in counts:
            counts[k] = 0
        probs, lens = time_sharded_forward(model.params, model.config,
                                           torch.from_numpy(_spect(name, n)),
                                           torch.tensor(lengths), mesh)
        out[name] = (probs.numpy(), lens.numpy(), dict(counts))
    try:
        kw = CASES["uni_length_mid_shard"][0]
        model = port_model(dict(kw, model_name="halo"), sds["uni_length_mid_shard"])
        time_sharded_forward(model.params, model.config, torch.zeros(1, 1, 161, 2 * n),
                             torch.tensor([2 * n]), mesh)
    except ValueError as e:
        out["halo_error"] = str(e)
    for key, cfg in (("long", LONG_CFG), ("long_uni", LONG_UNI_CFG)):
        rec = Recognizer(model=port_model(cfg, long_sds[key]), device="cpu")
        for k in counts:
            counts[k] = 0
        out[key] = (rec.recognize_long_form(wave, mesh=mesh), dict(counts))
    return out


@pytest.fixture(scope="module")
def sds():
    return {name: jax_state_dict(dict(kw, model_name=name), seed=1, bn_seed=2)
            for name, (kw, _, _) in CASES.items()}


@pytest.fixture(scope="module")
def long_sds():
    return {"long": jax_state_dict(LONG_CFG, seed=3, bn_seed=4),
            "long_uni": jax_state_dict(LONG_UNI_CFG, seed=5, bn_seed=6)}


@pytest.fixture(scope="module")
def ranks(sds, long_sds, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ts")
    wave = _long_wave()
    return {n: run_ranks(_ts_rank, n, tmp, sds, long_sds, wave) for n in SIZES}


def _jax_time_sharded(name, sd, n):
    import jax
    import jax.numpy as jnp

    from danspeech_tpu.parallel import make_mesh
    from danspeech_tpu.parallel.time_shard import time_sharded_forward

    kw, _, lengths = CASES[name]
    model = jax_model(dict(kw, model_name=name), sd)
    mesh = make_mesh(n_data=n, devices=jax.devices()[:n])
    probs, lens = time_sharded_forward(model.params, model.config,
                                       jnp.asarray(_spect(name, n)),
                                       jnp.asarray(lengths, jnp.int32), mesh)
    return np.asarray(probs), np.asarray(lens)


def _port_forward(name, sd, n):
    from danspeech_tpu_torch.models import deepspeech as ds

    kw, _, lengths = CASES[name]
    model = port_model(dict(kw, model_name=name), sd)
    probs, lens = ds.forward(model.params, model.config,
                             torch.from_numpy(_spect(name, n)), torch.tensor(lengths))
    return probs.numpy(), lens.numpy()


def _close(got, ref, lens):
    for i, k in enumerate(lens):
        np.testing.assert_allclose(got[i, :k], ref[i, :k], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_time_sharded_matches_jax_and_forward(ranks, sds, name, n):
    """Every rank's whole probabilities equal JAX's time-sharded forward at
    the same n, and the port's single-process forward."""
    ref, ref_lens = _port_forward(name, sds[name], n)
    jax_probs, jax_lens = _jax_time_sharded(name, sds[name], n)
    np.testing.assert_array_equal(jax_lens, ref_lens)
    for out in ranks[n]:
        probs, lens, _ = out[name]
        np.testing.assert_array_equal(lens, ref_lens)
        assert probs.shape == ref.shape
        _close(probs, ref, ref_lens)
        _close(probs, jax_probs, ref_lens)


def test_lookahead_spans_several_ranks():
    """The hop case's context needs frames beyond the next rank's chunk:
    at n = 4 each rank holds 6 frames and the context 19 more."""
    kw, t, _ = CASES["uni_lookahead_hops"]
    from danspeech_tpu_torch.models.config import DeepSpeechConfig
    from danspeech_tpu_torch.models.deepspeech import get_seq_lens

    t_local = int(get_seq_lens(DeepSpeechConfig(**kw), torch.tensor([t // 4])))
    assert kw["context"] - 1 >= 2 * t_local


@pytest.mark.parametrize("n", [2, 4])
def test_halo_larger_than_the_chunk_raises(ranks, n):
    for out in ranks[n]:
        assert "exceeds local chunk" in out["halo_error"]


@pytest.mark.parametrize("n", SIZES)
def test_routes_one_chain_b1_both_chains_b2(ranks, n):
    """A ring step with one active chain runs gru_scan (B1), one with both
    runs gru_scan_bidi (B2): at world size 1 every bidirectional layer is one
    B2 call; at n = 2 and 4 every rank makes two B1 calls a layer. The
    wavefront makes one B1 call a layer on every rank."""
    for out in ranks[n]:
        layers = CASES["bidi_ring"][0]["rnn_layers"]
        expect = ({"gru_scan": 0, "gru_scan_bidi": layers} if n == 1
                  else {"gru_scan": 2 * layers, "gru_scan_bidi": 0})
        assert out["bidi_ring"][2] == expect
        uni = CASES["uni_wavefront"][0]["rnn_layers"]
        assert out["uni_wavefront"][2] == {"gru_scan": uni, "gru_scan_bidi": 0}


@pytest.mark.parametrize("key", ["long", "long_uni"])
def test_recognize_long_form_matches_jax_and_recognize(ranks, long_sds, key):
    """Recognizer.recognize_long_form on a seeded 8-12 s waveform, at every
    world size: the transcript of the port's recognize and of the JAX
    package's transcribe_long_form."""
    import jax

    from danspeech_tpu.parallel import make_mesh
    from danspeech_tpu.parallel.time_shard import transcribe_long_form
    from danspeech_tpu_torch import Recognizer

    cfg = LONG_CFG if key == "long" else LONG_UNI_CFG
    wave = _long_wave()
    expected = Recognizer(model=port_model(cfg, long_sds[key]),
                          device="cpu").recognize(wave)
    jax_text = transcribe_long_form(jax_model(cfg, long_sds[key]),
                                    wave.astype(np.float32), make_mesh(n_data=4,
                                    devices=jax.devices()[:4]))
    assert jax_text == expected
    layers = cfg["rnn_layers"]
    for n in SIZES:
        for out in ranks[n]:
            text, counts = out[key]
            assert text == expected
            if key == "long_uni":
                assert counts == {"gru_scan": layers, "gru_scan_bidi": 0}
            elif n == 1:
                assert counts == {"gru_scan": 0, "gru_scan_bidi": layers}
