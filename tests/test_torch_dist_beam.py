"""The port's beam-sharded CTC search (danspeech_tpu_torch/decode/dist_beam.py)
on spawned gloo ranks on the CPU: bit for bit the port's single-device
beam, and the JAX package's ShardedBeamDecoder's strings. Twin of
tests/test_dist_beam.py.

Each world size runs every case in one spawned group. Top-level imports
stay torch, numpy and the port: the ARPA model and the probabilities are
made in the parent, with helpers that import JAX.
"""

import numpy as np
import pytest
import torch

from torch_ranks import jax_state_dict, port_model, run_ranks

LABELS = "_abcdefghijklmnopqrstuvwxyzæøåéü "
W = 16
T_MAX = 40
SIZES = np.array([40, 27, 9], np.int32)  # ragged rows
# name -> (probabilities, LM?, cutoff_top_n, alpha, beta)
CASES = {
    "no_lm": ("dirichlet", False, 40, 0.0, 0.0),
    "no_lm_cut": ("dirichlet", False, 6, 0.0, 0.0),
    "lm": ("words", True, 40, 1.3, 0.4),
    "lm_cut": ("words", True, 5, 0.8, 1.2),
}
CFG = dict(model_name="beam-rec", rnn_hidden_size=32, rnn_layers=2, conv_layers=2)


def _search(case, probs, lm, mesh=None):
    from danspeech_tpu_torch.decode.device_beam import ctc_beam_search_device
    from danspeech_tpu_torch.decode.dist_beam import ctc_beam_search_beam_sharded

    kind, use_lm, cut, alpha, beta = CASES[case]
    kw = dict(beam_width=W, lm=lm if use_lm else None, alpha=alpha, beta=beta,
              space=len(LABELS) - 1, cutoff_top_n=cut)
    p = torch.from_numpy(probs[kind])
    if mesh is None:
        out = ctc_beam_search_device(p, SIZES, **kw)
    else:
        out = ctc_beam_search_beam_sharded(p, SIZES, mesh, **kw)
    return tuple(t.numpy() for t in out)


def _beam_rank(rank, n, arpa, probs, sd, waves):
    from danspeech_tpu_torch import Recognizer
    from danspeech_tpu_torch.decode.device_lm import pack_device_lm
    from danspeech_tpu_torch.decode.dist_beam import ShardedBeamDecoder
    from danspeech_tpu_torch.decode.lm import load_arpa
    from danspeech_tpu_torch.parallel import make_mesh
    from danspeech_tpu_torch.parallel import mesh as pm

    mesh = make_mesh(device="cpu")
    lm = pack_device_lm(load_arpa(arpa), LABELS, device="cpu")
    out = {}
    for case in CASES:
        gathers = pm.all_gather.calls
        out[case] = _search(case, probs, lm, mesh)
        out[case + "_gathers"] = pm.all_gather.calls - gathers
    for use_lm in (False, True):
        dec = ShardedBeamDecoder(LABELS, mesh, beam_width=W, lm=arpa if use_lm else None,
                                 alpha=1.3, beta=0.4)
        out[f"decoder_{use_lm}"] = dec.decode(probs["words"], SIZES)[0]
    rec = Recognizer(model=port_model(CFG, sd), device="cpu")
    rec.update_decoder(lm=arpa, beam_width=W, backend="sharded", mesh=mesh)
    out["recognizer"] = (type(rec.danspeech_recognizer.decoder).__name__,
                         rec.recognize_batch(waves))
    try:
        ShardedBeamDecoder(LABELS, mesh, beam_width=W + 1)
    except ValueError as e:
        out["bad_width"] = str(e)
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from test_torch_beam import word_batch
    from test_torch_lm import arpa_text, random_words, write_text

    tmp = tmp_path_factory.mktemp("dist_beam")
    words = random_words(np.random.default_rng(3), 20)
    arpa = write_text(tmp / "lm.arpa", arpa_text(4, words, order=3))
    rng = np.random.default_rng(5)
    probs = {
        "words": word_batch(rng, words, 3, T_MAX).astype(np.float32),
        "dirichlet": rng.dirichlet(np.ones(len(LABELS)) * 0.2,
                                   size=(3, T_MAX)).astype(np.float32),
    }
    wave_rng = np.random.default_rng(9)
    waves = [(wave_rng.normal(size=k) * 2000).astype(np.float32)
             for k in (12000, 16000, 9000)]
    sd = jax_state_dict(CFG, seed=13, bn_seed=14)
    return dict(tmp=tmp, arpa=arpa, probs=probs, sd=sd, waves=waves)


@pytest.fixture(scope="module")
def ranks(setup):
    s = setup
    return {n: run_ranks(_beam_rank, n, s["tmp"], s["arpa"], s["probs"], s["sd"],
                         s["waves"]) for n in (2, 4)}


@pytest.fixture(scope="module")
def single(setup):
    from danspeech_tpu_torch.decode.device_lm import pack_device_lm
    from danspeech_tpu_torch.decode.lm import load_arpa

    lm = pack_device_lm(load_arpa(setup["arpa"]), LABELS, device="cpu")
    return {case: _search(case, setup["probs"], lm) for case in CASES}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_search_is_bit_equal_to_the_device_beam(ranks, single, case, n):
    """Labels, times, lens and scores of every beam, on every rank, equal the
    single-device search exactly; one all_gather a walked frame."""
    for out in ranks[n]:
        for got, ref, what in zip(out[case], single[case],
                                  ("labels", "times", "lens", "scores")):
            np.testing.assert_array_equal(got, ref, err_msg=what)
        assert out[case + "_gathers"] == int(SIZES.max())


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_decoder_strings_equal_jax(ranks, setup, n):
    """ShardedBeamDecoder's strings, with and without the 3-gram, equal the
    JAX package's ShardedBeamDecoder's at the same n."""
    import jax

    from danspeech_tpu.decode.dist_beam import ShardedBeamDecoder as JDecoder
    from danspeech_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_data=n, devices=jax.devices()[:n])
    for use_lm in (False, True):
        jdec = JDecoder(LABELS, mesh, beam_width=W, lm=setup["arpa"] if use_lm else None,
                        alpha=1.3, beta=0.4)
        ref = jdec.decode(setup["probs"]["words"], SIZES)[0]
        for out in ranks[n]:
            assert out[f"decoder_{use_lm}"] == ref
    assert "must divide" in ranks[n][0]["bad_width"]


@pytest.mark.parametrize("n", [2, 4])
def test_update_decoder_sharded_through_the_recognizer(ranks, setup, n):
    """Recognizer.update_decoder(backend="sharded", mesh=...) serves the
    transcripts of backend="device" on every rank."""
    from danspeech_tpu_torch import Recognizer

    rec = Recognizer(model=port_model(CFG, setup["sd"]), device="cpu")
    rec.update_decoder(lm=setup["arpa"], beam_width=W, backend="device")
    expected = rec.recognize_batch(setup["waves"])
    for out in ranks[n]:
        assert out["recognizer"] == ("ShardedBeamDecoder", expected)
    # without a mesh the sharded backend refuses, as in the JAX package
    with pytest.raises(ValueError, match="needs a mesh"):
        rec.update_decoder(backend="sharded")
