"""The port's host beam search (``BeamCTCDecoder``: the C++ decoder of
``native/ctcbeam`` and its Python oracle) against the JAX package's (CPU).

Same probabilities, same LM file: the strings and offsets of every beam
must be equal exactly, with no LM, with an ARPA LM, with a probing ``.klm``
and with a trie ``.klm``, through the native route and through the oracle.
"""

import os

import numpy as np
import pytest

from danspeech_tpu.decode.beam import BeamCTCDecoder as JBeam
from danspeech_tpu.decode.beam import prefix_beam_search as j_prefix_beam_search
from danspeech_tpu_torch.decode import native_beam
from danspeech_tpu_torch.decode.beam import BeamCTCDecoder as TBeam
from danspeech_tpu_torch.decode.beam import _LMScorer, prefix_beam_search
from danspeech_tpu_torch.decode.kenlm_reader import write_kenlm_probing
from danspeech_tpu_torch.decode.kenlm_trie import write_kenlm_trie
from danspeech_tpu_torch.decode.lm import load_arpa
from test_torch_lm import LABELS, arpa_text, random_words, write_text


def word_probs(rng, t_max, text, labels=LABELS):
    """A (T, C) probability stream biased towards spelling ``text`` (two
    frames a character, blank mass and noise), so that word boundaries and
    LM scores change the decisions."""
    c = len(labels)
    probs = np.full((t_max, c), 0.02, np.float64)
    for t in range(t_max):
        ch = text[(t // 2) % len(text)]
        probs[t, labels.index(ch)] += rng.uniform(0.5, 2.0)
        probs[t, 0] += rng.uniform(0.0, 1.5)
        probs[t] += rng.uniform(0, 0.05, c)
    probs /= probs.sum(-1, keepdims=True)
    return probs.astype(np.float32)


def word_batch(rng, words, rows, t_max, n_words=4):
    return np.stack([
        word_probs(rng, t_max, " ".join(words[i] for i in rng.integers(0, len(words), n_words)))
        for _ in range(rows)
    ])


@pytest.fixture(scope="module")
def lms(tmp_path_factory):
    d = tmp_path_factory.mktemp("beam_lm")
    words = random_words(np.random.default_rng(7), 20)
    arpa = write_text(d / "lm.arpa", arpa_text(8, words))
    lm = load_arpa(arpa)
    probing = str(d / "p.klm")
    write_kenlm_probing(lm, probing)
    trie = str(d / "t.klm")
    write_kenlm_trie(lm, trie)
    return words, {"none": None, "arpa": arpa, "probing": probing, "trie": trie}


@pytest.fixture(scope="module")
def probs(lms):
    words, _ = lms
    rng = np.random.default_rng(11)
    batch = word_batch(rng, words, 4, 50)
    sizes = np.array([50, 37, 50, 12], np.int32)
    return batch, sizes


def test_native_library_builds_into_the_port():
    path = native_beam._ensure_built()
    assert os.path.dirname(path) == native_beam.BUILD_DIR
    assert os.path.basename(path).startswith("libctcbeam-")
    assert os.path.isfile(path)


@pytest.mark.parametrize("lm_kind", ["none", "arpa", "probing", "trie"])
@pytest.mark.parametrize("route", ["native", "oracle"])
def test_beam_decoder_equals_jax(lms, probs, lm_kind, route):
    _, files = lms
    batch, sizes = probs
    kw = dict(lm_path=files[lm_kind], alpha=1.3, beta=0.4, beam_width=16,
              cutoff_top_n=40, blank_index=0)
    tdec, jdec = TBeam(LABELS, **kw), JBeam(LABELS, **kw)
    assert tdec._native is not None and jdec._native is not None
    if route == "oracle":
        tdec._native = jdec._native = None
    ts, toff = tdec.decode(batch, sizes)
    js, joff = jdec.decode(batch, sizes)
    assert ts == js
    for a, b in zip(toff, joff):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_native_and_oracle_agree_on_the_top_beam(lms, probs):
    _, files = lms
    batch, sizes = probs
    dec = TBeam(LABELS, lm_path=files["arpa"], alpha=1.3, beta=0.4, beam_width=16)
    native, _ = dec.decode(batch, sizes)
    dec._native = None
    oracle, _ = dec.decode(batch, sizes)
    assert [s[0] for s in native] == [s[0] for s in oracle]


@pytest.mark.parametrize("cut", [(40, 1.0), (5, 1.0), (40, 0.9)])
def test_prefix_beam_search_equals_jax(lms, probs, cut):
    words, files = lms
    batch, _ = probs
    lm = load_arpa(files["arpa"])
    scorer = _LMScorer(lm, LABELS, 0.8, 1.1, LABELS.index(" "))
    from danspeech_tpu.decode.beam import _LMScorer as JScorer
    from danspeech_tpu.decode.lm import load_arpa as j_load_arpa

    jscorer = JScorer(j_load_arpa(files["arpa"]), LABELS, 0.8, 1.1, LABELS.index(" "))
    a = prefix_beam_search(batch[0], beam_width=12, cutoff_top_n=cut[0],
                           cutoff_prob=cut[1], scorer=scorer)
    b = j_prefix_beam_search(batch[0], beam_width=12, cutoff_top_n=cut[0],
                             cutoff_prob=cut[1], scorer=jscorer)
    assert a == b
    assert any(LABELS.index(" ") in r[0] for r in a)  # words were formed


def test_python_fallback_when_the_native_build_fails(monkeypatch, lms, probs):
    """A failed build warns and decodes through the Python oracle, as the
    JAX package does."""
    _, files = lms
    batch, sizes = probs
    monkeypatch.setattr(native_beam, "_lib", None)
    monkeypatch.setattr(native_beam, "SOURCE", "/nonexistent/ctcbeam.cc")
    with pytest.warns(UserWarning, match="native beam decoder unavailable"):
        dec = TBeam(LABELS, lm_path=files["arpa"], alpha=1.3, beta=0.4, beam_width=8)
    assert dec._native is None
    ref = JBeam(LABELS, lm_path=files["arpa"], alpha=1.3, beta=0.4, beam_width=8)
    ref._native = None
    assert dec.decode(batch, sizes)[0] == ref.decode(batch, sizes)[0]
