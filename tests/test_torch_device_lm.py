"""The port's device LM (hash tables as int64 tensors, 32-bit hash
arithmetic on int64) against the JAX package's (CPU).

The packed tables must equal the JAX package's word for word; the probes
and scores must equal the JAX ones (float32, stated tolerance 1e-5; they
are bit-equal here) on OOV words, empty words, absent and OOV context
slots, and on negative log-probabilities, whose float32 bits are negative
as int32 and would be lost by a max over an int32 table.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from danspeech_tpu.decode import device_lm as jdl
from danspeech_tpu.decode.lm import load_arpa as j_load_arpa
from danspeech_tpu_torch.decode import device_lm as tdl
from danspeech_tpu_torch.decode.lm import load_arpa
from test_torch_lm import LABELS, arpa_text, random_words, write_text

TOL = 1e-5
M32 = 0xFFFFFFFF


@pytest.fixture(scope="module", params=[2, 3, 4])
def packed(request, tmp_path_factory):
    order = request.param
    words = random_words(np.random.default_rng(order), 30)
    arpa = write_text(tmp_path_factory.mktemp("dlm") / "lm.arpa",
                      arpa_text(40 + order, words, order))
    tlm, jlm = load_arpa(arpa), j_load_arpa(arpa)
    return order, words, tlm, tdl.pack_device_lm(tlm, LABELS, device="cpu"), \
        jdl.pack_device_lm(jlm, LABELS)


def test_tables_equal_jax_word_for_word(packed):
    _, _, _, t, j = packed
    assert (t.order, t.max_probe) == (j.order, j.max_probe)
    for name in ("ng_table", "voc_table"):
        tt, jt = getattr(t, name), np.asarray(getattr(j, name))
        assert tt.dtype == torch.int64 and tt.device.type == "cpu"
        np.testing.assert_array_equal(tt.numpy(), jt.astype(np.int64))
    # some stored log-probabilities are negative floats: their bits are
    # above 2**31, which an int32 table would turn negative
    assert int((t.ng_table[..., 2] >= 2**31).sum()) > 0


def test_mul32_matches_uint32_arithmetic():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, size=4096, dtype=np.uint64)
    a[:4] = [0, 1, 2**31, 2**32 - 1]
    ta = torch.from_numpy(a.astype(np.int64))
    for m in (tdl._WM1, tdl._WM2, tdl._NM1, tdl._NM2, tdl._SLOT_MIX, tdl._SLOT_MIX2,
              0xFFFFFFFF, 0x80000000):
        ref = (a.astype(np.uint32) * np.uint32(m)).astype(np.int64)
        np.testing.assert_array_equal(tdl._mul32(ta, m).numpy(), ref)
        c = rng.integers(0, 2**32, size=a.shape, dtype=np.uint64)
        ref_add = (a.astype(np.uint32) * np.uint32(m) + c.astype(np.uint32)).astype(np.int64)
        got = tdl._mul_add32(ta, m, torch.from_numpy(c.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy(), ref_add)
        assert tdl._mul32(int(a[5]), m) == int(ref[5])


def test_bits_to_f32_keeps_negative_log_probabilities():
    x = np.array([-1000.0, -2.5, -0.0, 0.0, 1.5, -1e-30], np.float32)
    bits = torch.from_numpy(x.view(np.uint32).astype(np.int64))
    np.testing.assert_array_equal(tdl._bits_to_f32(bits).numpy(), x)


def _word_hashes(words):
    idx = {ch: i for i, ch in enumerate(LABELS)}
    return np.array([tdl._h_word([idx[c] for c in w]) for w in words], np.int64)


def test_lookup_word_ids_matches_jax(packed):
    _, words, tlm, t, j = packed
    names = list(words) + ["zzzzzz", "qqq", "xoxo", "a"]
    h = _word_hashes(names)
    got = tdl.lookup_word_ids(t, torch.from_numpy(h[:, 0]), torch.from_numpy(h[:, 1]))
    ref = jdl.lookup_word_ids(j, jnp.asarray(h[:, 0], jnp.uint32),
                              jnp.asarray(h[:, 1], jnp.uint32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert [int(v) for v in got[: len(words)]] == [tlm.vocab[w] for w in words]


def _contexts(rng, n_vocab, order, n=400):
    ctx = rng.integers(0, n_vocab, size=(n, max(order - 1, 1)))
    ctx[rng.random(ctx.shape) < 0.3] = -1  # absent / OOV slots
    wid = rng.integers(0, n_vocab, size=n)
    wid[rng.random(n) < 0.1] = -1  # OOV words
    return ctx, wid


def test_score_word_ids_matches_jax_and_the_host_scorer(packed):
    order, _, tlm, t, j = packed
    ctx, wid = _contexts(np.random.default_rng(order), len(tlm.words), order)
    got = tdl.score_word_ids(t, torch.from_numpy(ctx), torch.from_numpy(wid))
    ref = jdl.score_word_ids(j, jnp.asarray(ctx, jnp.int32), jnp.asarray(wid, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)
    host = [tlm.score_word_ids(tuple(c for c in cx if c >= 0), int(w)) if w >= 0
            else -1000.0 for cx, w in zip(ctx, wid)]
    np.testing.assert_allclose(got.numpy(), host, rtol=1e-5, atol=1e-5)
    assert float(got.min()) == -1000.0 and float(got.max()) < 0


def _lm_state(rng, words, order, batch=3, w=5):
    """A (B, W) LM state whose current words are known words, OOV words and
    empty words (length 0), with random contexts."""
    names = list(words) + ["zzzz", "qq"]
    pick = rng.integers(0, len(names), size=(batch, w))
    h = _word_hashes([names[i] for i in pick.ravel()]).reshape(batch, w, 2)
    cw_len = np.array([[len(names[i]) for i in row] for row in pick], np.int64)
    cw_len[:, 0] = 0  # an empty word at every row's first beam
    ctx = rng.integers(-1, len(words), size=(batch, w, max(order - 1, 1)))
    return ctx, h[..., 0], h[..., 1], cw_len


@pytest.mark.parametrize("alpha,beta", [(1.3, 0.2), (0.0, 0.0), (2.0, -0.7)])
def test_boundary_and_final_scores_match_jax(packed, alpha, beta):
    order, words, _, t, j = packed
    ctx, h1, h2, cw_len = _lm_state(np.random.default_rng(order + 17), words, order)
    tstate = tuple(torch.from_numpy(a) for a in (ctx, h1, h2, cw_len))
    jstate = (jnp.asarray(ctx, jnp.int32), jnp.asarray(h1, jnp.uint32),
              jnp.asarray(h2, jnp.uint32), jnp.asarray(cw_len, jnp.int32))
    bscore, wid = tdl.boundary_scores(t, tstate, alpha, beta)
    jb, jw = jdl.boundary_scores(j, jstate, alpha, beta)
    np.testing.assert_allclose(bscore.numpy(), np.asarray(jb), rtol=0, atol=TOL)
    np.testing.assert_array_equal(wid.numpy(), np.asarray(jw))
    assert (bscore[:, 0] == 0).all() and (wid[:, 0] == -1).all()  # empty word
    space = LABELS.index(" ")
    last = np.random.default_rng(1).integers(-1, len(LABELS), size=cw_len.shape)
    last[0, :2] = space
    got = tdl.final_scores(t, tstate, torch.from_numpy(last), alpha, beta, space)
    ref = jdl.final_scores(j, jstate, jnp.asarray(last, jnp.int32), alpha, beta, space)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)


def test_reconstruct_lm_state_matches_jax(packed):
    order, words, _, t, j = packed
    rng = np.random.default_rng(order + 3)
    ctx, h1, h2, cw_len = _lm_state(rng, words, order)
    batch, w = cw_len.shape
    parent = rng.integers(0, w, size=(batch, w))
    char = rng.integers(-1, len(LABELS), size=(batch, w))
    space = LABELS.index(" ")
    char[:, 0] = space
    wid = rng.integers(-1, len(words), size=(batch, w))
    got = tdl.reconstruct_lm_state(
        tuple(torch.from_numpy(a) for a in (ctx, h1, h2, cw_len)),
        torch.from_numpy(parent), torch.from_numpy(char), torch.from_numpy(wid), space)
    ref = jdl.reconstruct_lm_state(
        (jnp.asarray(ctx, jnp.int32), jnp.asarray(h1, jnp.uint32),
         jnp.asarray(h2, jnp.uint32), jnp.asarray(cw_len, jnp.int32)),
        jnp.asarray(parent, jnp.int32), jnp.asarray(char, jnp.int32),
        jnp.asarray(wid, jnp.int32), space)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))


def test_init_lm_state_and_device_placement(packed):
    order, _, _, t, _ = packed
    ctx, h1, h2, n = tdl.init_lm_state(2, 4, order, device="cpu")
    assert ctx.shape == (2, 4, max(order - 1, 1)) and (ctx == -1).all()
    assert all(a.dtype == torch.int64 and not a.any() for a in (h1, h2, n))
    assert t.to("cpu") is t
    assert t.nbytes() == 8 * (t.ng_table.numel() + t.voc_table.numel())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t.to(None)
