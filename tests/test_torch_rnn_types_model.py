"""LSTM and tanh-RNN models of the PyTorch port against the JAX package
(CPU): seeded init, the weight bridge, .dsz checkpoints, the forward pass,
greedy transcripts through the two ``Recognizer``s, train steps, the training
loop and the CLI.

Tolerances. Softmax probabilities (values of order 1/33): F32_ATOL in
float32 (summation order only), BF16_ATOL with bf16 matmul weights (the
port's bf16 convolutions round their outputs to bf16, JAX keeps them in f32
before the RNN input is rounded to bf16 anyway). Train steps as
``tests/test_torch_train.py``: LOSS_TOL on a step's loss, GRAD_RTOL of each
leaf's largest entry on the gradients, at most 2 * lr per step and
PARAM_MEAN of lr on average on the updated parameters.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from danspeech_tpu import Recognizer as JRecognizer
from danspeech_tpu.features.spectrogram import AudioParser as JAudioParser
from danspeech_tpu.models import DeepSpeechModel as JModel
from danspeech_tpu.models import checkpoint as jckpt
from danspeech_tpu.models import deepspeech as jds
from danspeech_tpu.models.config import DeepSpeechConfig as JConfig
from danspeech_tpu.ops import stft as jstft
from danspeech_tpu.train import ctc as jctc
from danspeech_tpu.train import step as jstep
from danspeech_tpu_torch import Recognizer as TRecognizer
from danspeech_tpu_torch.audio import load_audio
from danspeech_tpu_torch.models import DeepSpeechModel as TModel
from danspeech_tpu_torch.models import checkpoint as tckpt
from danspeech_tpu_torch.models import deepspeech as tds
from danspeech_tpu_torch.models.config import DeepSpeechConfig as TConfig
from danspeech_tpu_torch.ops import lstm_cuda, rnn_tanh_cuda, walks
from danspeech_tpu_torch.ops import rnn as trnn
from danspeech_tpu_torch.train import continue_training, export_model, train
from danspeech_tpu_torch.train import step as tstep
from danspeech_tpu_torch.train.__main__ import main as cli_main
from danspeech_tpu_torch.train.checkpoint import latest_step

F32_ATOL = 1e-5
BF16_ATOL = 1e-2
LOSS_TOL = 1e-4
GRAD_RTOL = 2e-3
PARAM_MEAN = 0.05
LR = 1e-3

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TYPES = ["lstm", "rnn"]
QUIET = dict(log=lambda *a: None)


def _small(rnn_type, **kw):
    return dict(dict(model_name=f"small-{rnn_type}", rnn_type=rnn_type,
                     rnn_hidden_size=16, rnn_layers=2, conv_layers=2), **kw)


def _randomize_bn(sd, seed=7):
    """Non-trivial BN statistics (init leaves them at identity)."""
    rng = np.random.default_rng(seed)
    sd = dict(sd)
    for k in list(sd):
        if k.endswith("running_mean"):
            sd[k] = rng.normal(0.0, 0.3, sd[k].shape).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, sd[k].shape).astype(np.float32)
    return sd


def _models(seed=0, **cfg):
    jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
    sd = _randomize_bn(jckpt.state_dict_from_params(jds.init_params(jcfg, seed), jcfg))
    return (jcfg, jckpt.params_from_state_dict(sd, jcfg),
            tcfg, tckpt.params_from_state_dict(sd, tcfg))


def _spect(seed, n=3, t=120):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 1, 161, t)).astype(np.float32)
    lengths = np.array([t, t - 37, 9][:n], np.int32)
    x *= (np.arange(t)[None, :] < lengths[:, None])[:, None, None, :]
    return x, lengths


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("rnn_type", TYPES)
def test_init_params_bit_identical(rnn_type, bidirectional):
    cfg = _small(rnn_type, bidirectional=bidirectional, conv_layers=3)
    jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
    tparams = tds.init_params(tcfg, seed=5)
    ref = jckpt.state_dict_from_params(jds.init_params(jcfg, seed=5), jcfg)
    got = tckpt.state_dict_from_params(tparams, tcfg)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    gates = 4 if rnn_type == "lstm" else 1
    cls = trnn.LSTMWeights if rnn_type == "lstm" else trnn.RNNWeights
    entry = tparams["rnns"][1]
    assert type(entry["fwd"]) is cls and entry["fwd"].w_ih.shape == (16, gates * 16)
    assert (entry["bwd"] is not None) == bidirectional
    assert tds.num_params(tparams) == jds.num_params(jds.init_params(jcfg, seed=5))


@pytest.mark.parametrize("rnn_type", TYPES)
def test_state_dict_and_dsz_cross_both_ways(rnn_type, tmp_path):
    jcfg, jparams, tcfg, tparams = _models(**_small(rnn_type))
    ref = jckpt.state_dict_from_params(jparams, jcfg)
    got = tckpt.state_dict_from_params(tparams, tcfg)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    # torch's (G*H, I) layout in the state dict, the JAX package's names in the tree
    gates = 4 if rnn_type == "lstm" else 1
    assert got["rnns.0.rnn.weight_hh_l0_reverse"].shape == (gates * 16, 16)
    assert sorted(tckpt.flatten_tree(tparams)) == sorted(
        ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", None))))
                 for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0])

    jpath, tpath = str(tmp_path / "j.dsz"), str(tmp_path / "t.dsz")
    JModel(jcfg, jparams).save(jpath)
    TModel(tcfg, tparams).save(tpath)
    loaded = TModel.load_model(jpath)
    assert loaded.config.to_dict() == tcfg.to_dict() and loaded.config.rnn_type == rnn_type
    j_back = JModel.load_model(tpath)
    for sd in (tckpt.state_dict_from_params(loaded.params, loaded.config),
               jckpt.state_dict_from_params(j_back.params, j_back.config)):
        for k in ref:
            np.testing.assert_array_equal(np.asarray(sd[k]), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("rnn_type", TYPES)
def test_forward_f32_matches_jax(rnn_type, bidirectional):
    jcfg, jparams, tcfg, tparams = _models(**_small(rnn_type, bidirectional=bidirectional))
    x, lengths = _spect(0)
    got, got_len = tds.forward(tparams, tcfg, torch.from_numpy(x), torch.from_numpy(lengths))
    for rnn_impl in ("xla", "pallas"):
        ref, ref_len = jds.forward(jparams, jcfg, jnp.asarray(x), jnp.asarray(lengths),
                                   rnn_impl=rnn_impl)
        np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_ATOL, rtol=0,
                                   err_msg=rnn_impl)


@pytest.mark.parametrize("rnn_type", TYPES)
def test_forward_bf16_matches_jax_pallas(rnn_type):
    jcfg, jparams, tcfg, tparams = _models(**_small(rnn_type))
    x, lengths = _spect(2)
    ref, _ = jds.forward(jds.cast_matmul_weights(jparams), jcfg, jnp.asarray(x),
                         jnp.asarray(lengths), rnn_impl="pallas")
    tp = tds.cast_matmul_weights(tparams)
    assert tp["rnns"][0]["fwd"].w_hh.dtype == torch.bfloat16
    assert tp["rnns"][0]["bwd"].b_hh.dtype == torch.float32
    got, _ = tds.forward(tp, tcfg, torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=BF16_ATOL, rtol=0)
    plain, _ = tds.forward(tp, tcfg, torch.from_numpy(x), torch.from_numpy(lengths),
                           rnn_impl="plain")
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


@pytest.mark.parametrize("rnn_type", TYPES)
def test_greedy_transcripts_equal_through_both_recognizers(rnn_type):
    jcfg, jparams, tcfg, tparams = _models(seed=3, **_small(rnn_type))
    ours = TRecognizer(model=TModel(tcfg, tparams), device="cpu")
    theirs = JRecognizer(model=JModel(jcfg, jparams))
    clips = [load_audio(os.path.join(DATA, f"clip_{k}.wav")) for k in ("mono", "stereo")]
    for audio in clips:
        text = ours.recognize(audio)
        assert isinstance(text, str) and text == theirs.recognize(audio)
    assert ours.recognize_batch(clips) == theirs.recognize_batch(clips)
    # streaming is GRU-only in both packages
    with pytest.raises(NotImplementedError, match="GRU models only"):
        ours.enable_real_time_streaming(TModel(tcfg, tparams))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def jflatten(tree) -> dict:
    """A JAX parameter-shaped tree by the leaf names of ``flatten_tree``."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [getattr(k, "key", getattr(k, "idx", getattr(k, "name", None)))
                 for k in path]
        flat[".".join(str(p) for p in parts)] = np.asarray(leaf)
    return flat


def _wave_batch(seed, num_classes):
    rng = np.random.default_rng(seed)
    lens = np.array([8000, 6100, 3300, 8000], np.int32)
    waves = np.zeros((4, 8000), np.float32)
    for r, n in enumerate(lens):
        waves[r, :n] = rng.normal(size=n) * 2000.0
    labels = rng.integers(1, num_classes, size=(4, 8)).astype(np.int32)
    label_lens = np.array([6, 4, 2, 1], np.int32)
    weights = np.array([1.0, 1.0, 1.0, 0.0], np.float32)  # a padding row
    return waves, lens, labels, label_lens, weights


def _jax_loss(jcfg, batch, remat):
    """The loss of the JAX wave train step (float32, no augmentation), for
    jax.value_and_grad."""
    waves, lens, labels, label_lens, weights = (jnp.asarray(a) for a in batch)
    parser = JAudioParser(jcfg.audio_conf)

    def loss_of(params):
        spect, frame_lens = jstft.batched_log_spectrogram(
            waves, lens, parser.n_fft, parser.hop_length, parser.window)
        logits, out_lens = jds.forward(params, jcfg, spect[:, None], frame_lens,
                                       softmax=False, rnn_impl="auto", rnn_remat=remat)
        nll = jctc.ctc_loss(logits, out_lens, labels, label_lens,
                            blank_id=jcfg.blank_index)
        per = nll / jnp.maximum(label_lens, 1)
        return jnp.sum(per * weights) / jnp.maximum(jnp.sum(weights), 1e-6)

    return loss_of


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("rnn_type", TYPES)
def test_two_wave_train_steps_match_jax(rnn_type, remat):
    jcfg, jparams, tcfg, tparams = _models(**_small(rnn_type))
    batch = _wave_batch(3, jcfg.num_classes)

    jopt = jstep.make_optimizer(LR)
    jstate = jstep.TrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))
    jfn = jax.jit(jstep.make_wave_train_step(jcfg, jopt, mixed_precision=False,
                                             remat=remat))
    ref_loss0, ref_grads = jax.jit(jax.value_and_grad(_jax_loss(jcfg, batch, remat)))(jparams)

    topt = tstep.make_optimizer(LR)
    tstate = tstep.train_state_from_params(tparams, topt, device="cpu")
    tfn = tstep.make_wave_train_step(tcfg, topt, mixed_precision=False, remat=remat)

    losses = {"jax": [], "torch": []}
    for k in range(2):
        jstate, jl = jfn(jstate, *(jnp.asarray(a) for a in batch))
        tstate, tl = tfn(tstate, *batch)
        losses["jax"].append(float(jl))
        losses["torch"].append(float(tl))
        ref = jflatten(jstate.params)
        got = tckpt.flatten_tree(tstate.params)
        assert sorted(got) == sorted(ref)
        if k == 0:
            grads = tckpt.flatten_tree(tds.map_params(lambda p: p.grad, tstate.params))
            ref_g = jflatten(ref_grads)
            assert sorted(grads) == sorted(ref_g)
            for name in ref_g:
                scale = max(float(np.abs(ref_g[name]).max()), 1e-6)
                np.testing.assert_allclose(grads[name], ref_g[name], atol=GRAD_RTOL * scale,
                                           rtol=0, err_msg=f"gradient {name}")
        diff = np.concatenate([np.abs(got[n] - ref[n]).ravel() for n in ref])
        assert diff.max() <= 2.0 * LR * (k + 1) * 1.05
        assert diff.mean() <= PARAM_MEAN * LR
    np.testing.assert_allclose(losses["torch"][0], float(ref_loss0), atol=LOSS_TOL)
    np.testing.assert_allclose(losses["torch"], losses["jax"], atol=LOSS_TOL)
    assert losses["torch"][1] < losses["torch"][0]
    assert tstate.step == 2 and int(jstate.step) == 2


@pytest.mark.parametrize("rnn_type", TYPES)
def test_remat_runs_each_kernel_the_stated_number_of_times(rnn_type, monkeypatch):
    """Per layer and direction of a rematerialised train step: the forward
    that keeps nothing, the recomputed forward (for the LSTM the one with the
    cell stream) and one backward walk; without remat the first of them does
    not run. Remat does not change the gradients."""
    calls = []  # one entry a chain walks.run walked, by the wrapper whose Walk it is
    kinds = {"lstm_scan": lstm_cuda.LSTM_SCAN,
             "lstm_scan_with_cell": lstm_cuda.LSTM_SCAN_WITH_CELL,
             "lstm_bwd_scan": lstm_cuda.LSTM_BWD_SCAN,
             "rnn_tanh_scan": rnn_tanh_cuda.RNN_TANH_SCAN,
             "rnn_tanh_bwd_scan": rnn_tanh_cuda.RNN_TANH_BWD_SCAN}
    run = walks.run

    def spy(walk, chains, reverses, design=None):
        calls.extend(n for n, w in kinds.items() if w is walk for _ in chains)
        return run(walk, chains, reverses, design)

    monkeypatch.setattr(walks, "run", spy)
    _, _, tcfg, tparams = _models(**_small(rnn_type))
    x, lengths = _spect(4)
    chains = 2 * tcfg.rnn_layers
    grads = {}
    for remat in (True, False):
        del calls[:]
        leaves = tds.map_params(lambda p: p.clone().requires_grad_(True), tparams)
        out, _ = tds.forward(leaves, tcfg, torch.from_numpy(x), torch.from_numpy(lengths),
                             softmax=False, rnn_remat=remat)
        out.square().sum().backward()
        grads[remat] = tckpt.flatten_tree(tds.map_params(lambda p: p.grad, leaves))
        count = {n: calls.count(n) for n in set(calls)}
        if rnn_type == "lstm":
            want = {"lstm_scan_with_cell": chains, "lstm_bwd_scan": chains}
            if remat:
                want["lstm_scan"] = chains
        else:
            want = {"rnn_tanh_scan": chains * (2 if remat else 1),
                    "rnn_tanh_bwd_scan": chains}
        assert count == want
    for name in grads[True]:
        np.testing.assert_allclose(grads[True][name], grads[False][name], atol=1e-6,
                                   rtol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("rnn_types_corpus")
    man = d / "train.csv"
    man.write_text(
        f"{os.path.join(DATA, 'clip_mono.wav')},hej med dig\n"
        f"{os.path.join(DATA, 'clip_stereo.wav')},god dag\n", encoding="utf-8")
    return str(man)


def test_lstm_train_continue_export(corpus, tmp_path):
    config = TConfig(**_small("lstm"))
    ckpt = str(tmp_path / "ck")
    seen = []
    first = train(config, corpus, epochs=2, batch_size=2, learning_rate=1e-3, anneal=None,
                  augment=False, checkpoint_dir=ckpt, val_manifest=corpus, device="cpu",
                  stop_fn=lambda e, s, loss, wer: seen.append((loss, wer)) or False, **QUIET)
    assert first.step == 2 and latest_step(ckpt) == 2
    assert seen[1][0] < seen[0][0] and all(w >= 0.0 for _, w in seen)
    lines = []
    state = continue_training(config, corpus, ckpt, epochs=3, batch_size=2,
                              learning_rate=1e-3, anneal=None, augment=False,
                              device="cpu", log=lines.append)
    assert any("resumed step 2 (epoch 2)" in s for s in lines) and state.step == 3
    path = export_model(state, config, str(tmp_path / "lstm.dsz"))
    jconfig, jparams = jckpt.load_checkpoint(path)
    assert jconfig.rnn_type == "lstm"
    audio = load_audio(os.path.join(DATA, "clip_mono.wav"))
    ours = TRecognizer(model=TModel.load_model(path), device="cpu").recognize(audio)
    assert ours == JRecognizer(model=JModel(jconfig, jparams)).recognize(audio)


def test_cli_trains_a_tanh_rnn_on_the_cpu(corpus, tmp_path, capsys):
    out = tmp_path / "tanh.dsz"
    cli_main(["--manifest", corpus, "--epochs", "2", "--batch-size", "2", "--lr", "1e-3",
              "--rnn-type", "rnn", "--hidden", "16", "--rnn-layers", "2",
              "--conv-layers", "2", "--export", str(out), "--no-augment",
              "--device", "cpu"])
    assert "exported" in capsys.readouterr().out
    model = TModel.load_model(str(out))
    assert model.config.rnn_type == "rnn"
    assert type(model.params["rnns"][0]["fwd"]) is trnn.RNNWeights
