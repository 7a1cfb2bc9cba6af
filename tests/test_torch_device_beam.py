"""The port's device beam search (torch ops, here on CPU tensors) against
the JAX package's ``ctc_beam_search_device`` / ``DeviceBeamDecoder`` (CPU),
and against the port's own host decoders.

On identical probabilities: labels, times, lens and the per-frame parent
and char pointers must be equal, and the scores within 1e-5 — with and
without an LM, with and without the per-frame class cut
(``cutoff_top_n < C``), over rows of ragged lengths, and through the
decoder with ``n_best=1``.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from danspeech_tpu.decode import device_beam as jdb
from danspeech_tpu.decode.device_lm import pack_device_lm as j_pack
from danspeech_tpu.decode.lm import load_arpa as j_load_arpa
from danspeech_tpu_torch.decode import device_beam as tdb
from danspeech_tpu_torch.decode.beam import BeamCTCDecoder, _LMScorer, prefix_beam_search
from danspeech_tpu_torch.decode.device_lm import pack_device_lm
from danspeech_tpu_torch.decode.lm import load_arpa
from test_torch_beam import word_batch
from test_torch_lm import LABELS, arpa_text, random_words, write_text

SPACE = LABELS.index(" ")
SCORE_TOL = 1e-5
T_MAX = 48
SIZES = np.array([48, 31, 9], np.int32)  # ragged rows


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    words = random_words(np.random.default_rng(3), 20)
    arpa = write_text(tmp_path_factory.mktemp("dbeam") / "lm.arpa", arpa_text(4, words))
    tlm, jlm = load_arpa(arpa), j_load_arpa(arpa)
    rng = np.random.default_rng(5)
    probs = {
        "words": word_batch(rng, words, 3, T_MAX),
        "dirichlet": rng.dirichlet(np.ones(len(LABELS)) * 0.2,
                                   size=(3, T_MAX)).astype(np.float32),
    }
    return dict(arpa=arpa, tlm=tlm, jlm=jlm, words=words, probs=probs,
                tdlm=pack_device_lm(tlm, LABELS, device="cpu"),
                jdlm=j_pack(jlm, LABELS))


# name -> (probabilities, LM?, cutoff_top_n, alpha, beta)
CASES = {
    "no_lm": ("dirichlet", False, 40, 0.0, 0.0),
    "no_lm_cut": ("dirichlet", False, 6, 0.0, 0.0),
    "lm": ("words", True, 40, 1.3, 0.4),
    "lm_cut": ("words", True, 5, 0.8, 1.2),
}
W = 16


def _run(setup, case, monkeypatch, sizes=SIZES):
    """Both searches on the same inputs; each side's backtrack is wrapped so
    that its per-frame pointers come out beside its results."""
    kind, with_lm, cut, alpha, beta = CASES[case]
    probs = setup["probs"][kind]
    seen = {}

    real_t = tdb.backtrack_beams

    def t_backtrack(pb, pnb, parents, chars, t_max, extra_scores=None, top=None):
        seen["t"] = (parents, chars)
        return real_t(pb, pnb, parents, chars, t_max, extra_scores=extra_scores, top=top)

    real_j = jdb.backtrack_beams

    def j_backtrack(pb, pnb, parents, chars, t_max, extra_scores=None):
        return real_j(pb, pnb, parents, chars, t_max, extra_scores=extra_scores), \
            (parents, chars)

    monkeypatch.setattr(tdb, "backtrack_beams", t_backtrack)
    monkeypatch.setattr(jdb, "backtrack_beams", j_backtrack)
    got = tdb.ctc_beam_search_device(
        torch.from_numpy(probs), sizes, beam_width=W,
        lm=setup["tdlm"] if with_lm else None, alpha=alpha, beta=beta,
        space=SPACE, cutoff_top_n=cut)
    # the un-jitted function, so that the wrapped backtrack is the one called
    ref, (j_par, j_chr) = jdb.ctc_beam_search_device.__wrapped__(
        jnp.asarray(probs), jnp.asarray(sizes), beam_width=W,
        lm=setup["jdlm"] if with_lm else None, alpha=alpha, beta=beta,
        space=SPACE, cutoff_top_n=cut)
    return got, ref, seen["t"], (np.asarray(j_par), np.asarray(j_chr))


@pytest.mark.parametrize("case", list(CASES))
def test_search_equals_jax(setup, case, monkeypatch):
    got, ref, (t_par, t_chr), (j_par, j_chr) = _run(setup, case, monkeypatch)
    for name, a, b in zip(("labels", "times", "lens"), got[:3], ref[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=0, atol=SCORE_TOL)
    # pointers: the port walks frames up to the longest row; the JAX scan
    # walks every frame, and past the longest row its pointers keep each
    # beam with no emission
    walked = len(t_par)
    assert walked == SIZES.max()
    np.testing.assert_array_equal(torch.stack(t_par).numpy(), j_par[:walked])
    np.testing.assert_array_equal(torch.stack(t_chr).numpy(), j_chr[:walked])
    assert (j_par[walked:] == np.arange(W)).all() and (j_chr[walked:] == -1).all()
    # rows past their length froze: no emission after their last frame
    for b, n in enumerate(SIZES):
        assert (j_chr[n:, b] == -1).all()


def test_pointers_at_every_frame_of_a_full_length_batch(setup, monkeypatch):
    """All rows full length: every frame's pointers are compared."""
    got, ref, (t_par, t_chr), (j_par, j_chr) = _run(
        setup, "lm_cut", monkeypatch, sizes=np.full(3, T_MAX, np.int32))
    assert len(t_par) == T_MAX
    np.testing.assert_array_equal(torch.stack(t_par).numpy(), j_par)
    np.testing.assert_array_equal(torch.stack(t_chr).numpy(), j_chr)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))


@pytest.mark.parametrize("lm", [False, True])
def test_decoder_equals_jax_decoder(setup, lm):
    probs = setup["probs"]["words"]
    kw = dict(beam_width=W, alpha=1.3, beta=0.4)
    tdec = tdb.DeviceBeamDecoder(LABELS, lm=setup["tlm"] if lm else None, device="cpu", **kw)
    jdec = jdb.DeviceBeamDecoder(LABELS, lm=setup["jlm"] if lm else None, **kw)
    assert tdec.lm is None or tdec.lm.device.type == "cpu"
    ts, toff = tdec.decode(probs, SIZES)
    js, joff = jdec.decode(probs, SIZES)
    assert ts == js and len(ts[0]) == W
    for a, b in zip(toff, joff):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    one, one_off = tdec.decode(torch.from_numpy(probs), SIZES, n_best=1)
    assert one == [[s[0]] for s in js] == jdec.decode(probs, SIZES, n_best=1)[0]
    for a, b in zip(one_off, joff):
        np.testing.assert_array_equal(a[0], b[0])


def test_decoder_defaults_to_cuda():
    if torch.cuda.is_available():
        assert tdb.DeviceBeamDecoder(LABELS).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdb.DeviceBeamDecoder(LABELS)


@pytest.mark.parametrize("seed,t", [(0, 12), (1, 25), (2, 40)])
def test_matches_the_host_oracle_without_lm(seed, t):
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.ones(len(LABELS)) * 0.2, size=t).astype(np.float32)
    strings, _ = tdb.DeviceBeamDecoder(LABELS, beam_width=16, device="cpu").decode(
        probs[None], np.array([t]))
    ref = prefix_beam_search(probs, beam_width=16, cutoff_top_n=len(LABELS))
    ref_strings = ["".join(LABELS[c] for c in r[0]) for r in ref]
    assert strings[0][0] == ref_strings[0]
    k = min(8, len(ref_strings))
    assert strings[0][:k] == ref_strings[:k]


@pytest.mark.parametrize("row", [0, 1, 2])
def test_lm_search_matches_the_host_oracle_and_the_native_beam(setup, row):
    probs = setup["probs"]["words"][row]
    alpha, beta = 1.3, 0.4
    host = prefix_beam_search(probs, beam_width=16,
                              scorer=_LMScorer(setup["tlm"], LABELS, alpha, beta, SPACE))
    host_best = "".join(LABELS[c] for c in host[0][0])
    labels, times, lens, scores = tdb.ctc_beam_search_device(
        torch.from_numpy(probs[None]), [len(probs)], beam_width=16,
        lm=setup["tdlm"], alpha=alpha, beta=beta, space=SPACE)
    dev = {}
    for k in range(16):
        s = "".join(LABELS[c] for c in labels[0, k, : int(lens[0, k])])
        dev.setdefault(s, float(scores[0, k]))
    assert next(iter(dev)) == host_best
    host_scores = {"".join(LABELS[c] for c in p): sc for p, sc, _ in host}
    shared = set(dev) & set(host_scores)
    assert len(shared) >= 5
    for s in shared:
        assert math.isfinite(dev[s])
        np.testing.assert_allclose(dev[s], host_scores[s], rtol=1e-3, atol=1e-3)
    native = BeamCTCDecoder(LABELS, lm_path=setup["tlm"], alpha=alpha, beta=beta,
                            beam_width=16)
    assert native._native is not None
    assert native.decode(probs[None])[0][0][0] == host_best


def test_rows_are_independent_and_lengths_mask(setup):
    probs = setup["probs"]["dirichlet"]
    dec = tdb.DeviceBeamDecoder(LABELS, beam_width=8, lm=setup["tlm"], alpha=1.0,
                                beta=0.5, device="cpu")
    both, _ = dec.decode(probs[:2], np.array([T_MAX, 20]))
    assert both[0] == dec.decode(probs[:1], np.array([T_MAX]))[0][0]
    assert both[1] == dec.decode(probs[1:2, :20], np.array([20]))[0][0]


def test_float32_near_tie_flip_against_the_host_beam_is_pinned(setup):
    """ROADMAP C16: the device beam sums float32 scores (as the JAX package
    does), the C++ host beam float64. On this input their best transcripts
    differ at a float32 near tie (scores near -1742.82 that differ by
    2.4e-4); the same search with float64 scores picks the host beam's
    transcript, and the JAX package's device beam makes the port's float32
    choice."""
    rng = np.random.default_rng(70)
    p = np.exp(rng.normal(size=(1, 400, len(LABELS))) * 2.0)
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    kw = dict(beam_width=32, alpha=1.3, beta=0.2)
    host = BeamCTCDecoder(LABELS, lm_path=setup["tlm"], **kw)
    (h_ids, h_score, _), = host._native.decode_batch(p, np.array([400], np.int32))[0][:1]

    def top(probs):
        lab, _, lens, sc = tdb.ctc_beam_search_device(
            probs, [400], lm=setup["tdlm"], space=SPACE, top=1, **kw)
        return tuple(int(c) for c in lab[0, 0, : int(lens[0, 0])]), float(sc[0, 0])

    f32, s32 = top(torch.from_numpy(p))
    f64, s64 = top(torch.from_numpy(p).double())
    assert f32 != h_ids
    assert abs(s32 - h_score) < 1e-3
    assert f64 == h_ids
    assert abs(s64 - h_score) < 1e-3
    jl, _, jn, _ = jdb.ctc_beam_search_device(
        jnp.asarray(p), jnp.asarray([400], jnp.int32), lm=setup["jdlm"],
        space=SPACE, **kw)
    assert tuple(np.asarray(jl)[0, 0, : int(np.asarray(jn)[0, 0])]) == f32
