"""The port's n-gram LM readers and writers against the JAX package's (CPU).

ARPA text, KenLM probing ``.klm`` and KenLM trie ``.klm`` (all four trie
variants): the port's writers must write the JAX writers' bytes, and every
reader must score every query exactly as the JAX reader does on the same
file. The LMs are seeded ARPA texts written by the test; the helpers here
are shared with the other LM and beam test files of the port.
"""

import os

import numpy as np
import pytest

from danspeech_tpu.decode import kenlm_reader as jkr
from danspeech_tpu.decode import kenlm_trie as jkt
from danspeech_tpu.decode import lm as jlm
from danspeech_tpu_torch.decode import kenlm_reader as tkr
from danspeech_tpu_torch.decode import kenlm_trie as tkt
from danspeech_tpu_torch.decode import lm as tlm

LABELS = "_abcdefghijklmnopqrstuvwxyzæøåéü "


def random_words(rng, n_words, chars=LABELS[1:-1], max_len=5):
    words = set()
    while len(words) < n_words:
        n = int(rng.integers(1, max_len + 1))
        words.add("".join(chars[i] for i in rng.integers(0, len(chars), n)))
    return sorted(words)


def arpa_text(seed, words, order=3, n_ngrams=None, specials=True):
    """A seeded backoff LM over ``words`` as ARPA text: every unigram, then
    random bigrams and trigrams, suffix-closed as every kenlm-built model
    is (a trie and a probing file then score alike). log10 values with four
    decimals, so every reader parses the same numbers."""
    rng = np.random.default_rng(seed)
    n_ngrams = n_ngrams or 3 * len(words)
    vocab = list(words) + (["<unk>", "<s>", "</s>"] if specials else [])
    tables = [dict() for _ in range(order)]
    for w in vocab:
        tables[0][(w,)] = (rng.uniform(-4, -0.5), rng.uniform(-1, 0))
    for n in range(2, order + 1):
        for _ in range(n_ngrams):
            ids = tuple(words[i] for i in rng.integers(0, len(words), n))
            tables[n - 1][ids] = (rng.uniform(-3, -0.1), rng.uniform(-1, 0))
    for n in range(order, 2, -1):  # suffix closure
        for ids in list(tables[n - 1]):
            suffix = ids[1:]
            while len(suffix) >= 2 and suffix not in tables[len(suffix) - 1]:
                tables[len(suffix) - 1][suffix] = (rng.uniform(-3, -0.2),
                                                   rng.uniform(-1, 0))
                suffix = suffix[1:]
    lines = ["\\data\\"]
    lines += [f"ngram {n + 1}={len(t)}" for n, t in enumerate(tables)]
    for n, t in enumerate(tables):
        lines += ["", f"\\{n + 1}-grams:"]
        for ids, (p, b) in t.items():
            entry = f"{p:.4f}\t{' '.join(ids)}"
            lines.append(entry + (f"\t{b:.4f}" if n + 1 < order else ""))
    lines += ["", "\\end\\", ""]
    return "\n".join(lines)


def write_text(path, text):
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return str(path)


def queries(rng, words, order, n=300):
    """(context words, word) pairs: known and unknown words, short and
    full contexts."""
    pool = list(words) + ["zzzzzz", "qqq"]
    out = []
    for _ in range(n):
        k = int(rng.integers(0, order))
        ctx = [pool[i] for i in rng.integers(0, len(pool), k)]
        out.append((ctx, pool[int(rng.integers(0, len(pool)))]))
    return out


@pytest.fixture(scope="module")
def lm_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm")
    words = random_words(np.random.default_rng(0), 25)
    arpa = write_text(d / "lm.arpa", arpa_text(1, words))
    return d, words, arpa


def _same_scores(a, b, words, order, seed=3, tol=0.0):
    for ctx, w in queries(np.random.default_rng(seed), words, order):
        assert a.score_word(ctx, w) == pytest.approx(b.score_word(ctx, w),
                                                     abs=tol, rel=0), (ctx, w)


def test_load_arpa_matches_jax(lm_files):
    _, words, arpa = lm_files
    a, b = tlm.load_arpa(arpa), jlm.load_arpa(arpa)
    assert a.order == b.order == 3
    assert a.words == b.words
    assert a.tables == b.tables
    _same_scores(a, b, words, 3)
    # load_lm dispatches on the extension
    assert tlm.load_lm(arpa).tables == b.tables


def test_gzipped_arpa_and_packed_table(lm_files):
    import gzip

    d, words, arpa = lm_files
    gz = str(d / "lm.arpa.gz")
    with open(arpa, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    a = tlm.load_lm(gz)
    assert a.tables == jlm.load_arpa(arpa).tables
    pa, pb = tlm.PackedNgramLM(a), jlm.PackedNgramLM(jlm.load_arpa(arpa))
    np.testing.assert_array_equal(pa.keys, pb.keys)
    np.testing.assert_array_equal(pa.probs, pb.probs)
    np.testing.assert_array_equal(pa.backoffs, pb.backoffs)
    _same_scores(pa, pb, words, 3)


@pytest.mark.parametrize("order", [2, 3, 4])
def test_probing_klm_bytes_and_scores_match_jax(tmp_path, order):
    words = random_words(np.random.default_rng(order), 20)
    arpa = write_text(tmp_path / "lm.arpa", arpa_text(10 + order, words, order))
    tpath, jpath = str(tmp_path / "t.klm"), str(tmp_path / "j.klm")
    tkr.write_kenlm_probing(tlm.load_arpa(arpa), tpath)
    jkr.write_kenlm_probing(jlm.load_arpa(arpa), jpath)
    with open(tpath, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    a, b = tlm.load_lm(tpath), jlm.load_lm(jpath)
    assert isinstance(a, tkr.KenLMProbingModel)
    assert a.order == b.order == order
    _same_scores(a, b, words, order)
    # the probing file scores as its ARPA source does, within the float32
    # rounding of the stored values
    _same_scores(a, tlm.load_arpa(arpa), words, order, seed=4, tol=1e-5)


TRIE_VARIANTS = [
    dict(),
    dict(quantized=True),
    dict(bhiksha=True),
    dict(quantized=True, bhiksha=True, prob_bits=6, backoff_bits=5),
]


@pytest.mark.parametrize("variant", range(len(TRIE_VARIANTS)))
def test_trie_klm_bytes_and_scores_match_jax(tmp_path, variant):
    kw = TRIE_VARIANTS[variant]
    words = random_words(np.random.default_rng(20 + variant), 20)
    arpa = write_text(tmp_path / "lm.arpa", arpa_text(30 + variant, words))
    tpath, jpath = str(tmp_path / "t.klm"), str(tmp_path / "j.klm")
    tkt.write_kenlm_trie(tlm.load_arpa(arpa), tpath, **kw)
    jkt.write_kenlm_trie(jlm.load_arpa(arpa), jpath, **kw)
    with open(tpath, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    a, b = tlm.load_lm(tpath), jlm.load_lm(jpath)
    assert type(a).__name__ == type(b).__name__
    _same_scores(a, b, words, 3)
    # walkable into an NgramLM, as the JAX model is
    assert a.to_ngram_lm().tables == b.to_ngram_lm().tables


def test_coerce_device_lm_refuses_a_probing_binary(tmp_path, lm_files):
    _, _, arpa = lm_files
    klm = str(tmp_path / "p.klm")
    tkr.write_kenlm_probing(tlm.load_arpa(arpa), klm)
    with pytest.raises(ValueError, match="backend='host'"):
        tlm.coerce_device_lm(klm, LABELS, device="cpu")
    assert tlm.coerce_device_lm(None, LABELS, device="cpu") is None
    # a path, an NgramLM and a trie model all pack; a DeviceLM passes through
    dlm = tlm.coerce_device_lm(arpa, LABELS, device="cpu")
    assert dlm.device.type == "cpu" and dlm.order == 3
    assert tlm.coerce_device_lm(dlm, LABELS, device="cpu") is dlm
    trie = str(tmp_path / "t.klm")
    tkt.write_kenlm_trie(tlm.load_arpa(arpa), trie)
    packed = tlm.coerce_device_lm(tlm.load_lm(trie), LABELS, device="cpu")
    ref = jlm.coerce_device_lm(jlm.load_lm(trie), LABELS)
    np.testing.assert_array_equal(packed.ng_table.numpy(),
                                  np.asarray(ref.ng_table).astype(np.int64))
    np.testing.assert_array_equal(packed.voc_table.numpy(),
                                  np.asarray(ref.voc_table).astype(np.int64))


def test_murmur_and_ngram_hashes_match_jax():
    rng = np.random.default_rng(5)
    for word in random_words(rng, 30) + ["", "<unk>", "æøå"]:
        data = word.encode("utf-8")
        assert tkr.murmur_hash64a(data) == jkr.murmur_hash64a(data)
    for _ in range(50):
        ids = [int(i) for i in rng.integers(0, 10**6, int(rng.integers(1, 5)))]
        assert tkr.ngram_hash(ids) == jkr.ngram_hash(ids)
    assert os.path.basename(tkr.__file__) == "kenlm_reader.py"
