"""Training step of the PyTorch port against the JAX package (CPU, float32).

The same seeded numpy inputs and the same bridged parameters go through
``danspeech_tpu.train`` (optax) and ``danspeech_tpu_torch.train``
(``torch.optim``). Trees cross by leaf name (``flatten_tree``), BatchNorm
running statistics included: every leaf is trained in both packages.

Tolerances. CTC values and logit gradients: CTC_TOL (two log-space
recursions in another order). Loss of a step: LOSS_TOL. Gradients:
GRAD_RTOL of each leaf's largest entry (summation order through two conv
blocks, two GRU layers and the CTC lattice, and the spectrogram's ~3e-4
difference near empty bins, ROADMAP C4). Updated parameters: Adam's first
steps move every entry by about the learning rate in the direction of its
gradient's sign, so an entry whose gradient is within rounding of zero can
land a whole step apart: at most 2 * lr per step, and PARAM_MEAN of lr on
average.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from danspeech_tpu.models import checkpoint as jckpt
from danspeech_tpu.models import deepspeech as jds
from danspeech_tpu.models.config import DeepSpeechConfig as JConfig
from danspeech_tpu.ops import stft as jstft
from danspeech_tpu.train import ctc as jctc
from danspeech_tpu.train import step as jstep
from danspeech_tpu.features.spectrogram import AudioParser as JAudioParser
from danspeech_tpu_torch.errors import FreezingMoreLayersThanExist
from danspeech_tpu_torch.models import checkpoint as tckpt
from danspeech_tpu_torch.models import deepspeech as tds
from danspeech_tpu_torch.models.config import DeepSpeechConfig as TConfig
from danspeech_tpu_torch.train import augment as taug
from danspeech_tpu_torch.train import ctc as tctc
from danspeech_tpu_torch.train import step as tstep

CTC_TOL = 1e-4
LOSS_TOL = 1e-4
GRAD_RTOL = 2e-3
PARAM_MEAN = 0.05
LR = 1e-3


def jflatten(tree) -> dict:
    """A JAX parameter-shaped tree by the leaf names of ``flatten_tree``."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [getattr(k, "key", getattr(k, "idx", getattr(k, "name", None)))
                 for k in path]
        flat[".".join(str(p) for p in parts)] = np.asarray(leaf)
    return flat


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------


def _ctc_case(seed, b=5, t=30, c=12, n=8):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, t, c)).astype(np.float32)
    logit_lens = np.array([30, 25, 22, 30, 17], np.int32)[:b]
    labels = rng.integers(1, c, size=(b, n)).astype(np.int32)
    labels[1, :5] = [3, 3, 3, 7, 7]  # repeated labels need blanks between
    label_lens = np.array([8, 5, 3, 1, 0], np.int32)[:b]  # the last row is empty
    return logits, logit_lens, labels, label_lens


def test_ctc_loss_values_and_gradients_match_jax():
    logits, logit_lens, labels, label_lens = _ctc_case(0)
    w = np.random.default_rng(1).uniform(0.5, 1.5, len(label_lens)).astype(np.float32)

    def jloss(lg):
        nll = jctc.ctc_loss(lg, jnp.asarray(logit_lens), jnp.asarray(labels),
                            jnp.asarray(label_lens))
        return jnp.sum(nll * w), nll

    (_, ref), ref_grad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    got = tctc.ctc_loss(lg, torch.from_numpy(logit_lens), torch.from_numpy(labels),
                        torch.from_numpy(label_lens))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=CTC_TOL,
                               rtol=CTC_TOL)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(ref_grad), atol=CTC_TOL, rtol=0)
    # rows are frozen at their logit length: frames past it get no gradient
    for row, n in enumerate(logit_lens):
        assert float(np.abs(lg.grad[row, n:].numpy()).max(initial=0.0)) == 0.0
    # the empty row's loss is the negative log-probability of all blanks
    lp = torch.log_softmax(torch.from_numpy(logits[4, :17]), -1)[:, 0].sum()
    np.testing.assert_allclose(float(got[4].detach()), -float(lp), rtol=1e-5)

    ref_mean = jctc.mean_ctc_loss(jnp.asarray(logits), jnp.asarray(logit_lens),
                                  jnp.asarray(labels), jnp.asarray(label_lens))
    got_mean = tctc.mean_ctc_loss(torch.from_numpy(logits), torch.from_numpy(logit_lens),
                                  torch.from_numpy(labels), torch.from_numpy(label_lens))
    np.testing.assert_allclose(float(got_mean), float(ref_mean), rtol=CTC_TOL)


def test_ctc_infeasible_row_diverges_as_stated():
    """More labels than frames: inf here, a finite 1e30-scale value in the
    JAX package (its log-zero is -1e30). No zero_infinity on either side."""
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 6, 5)).astype(np.float32)
    labels = np.array([[1, 2, 3, 4, 1, 2, 3, 4], [1, 2, 0, 0, 0, 0, 0, 0]], np.int32)
    logit_lens, label_lens = np.array([6, 6], np.int32), np.array([8, 2], np.int32)
    ref = np.asarray(jctc.ctc_loss(jnp.asarray(logits), jnp.asarray(logit_lens),
                                   jnp.asarray(labels), jnp.asarray(label_lens)))
    got = tctc.ctc_loss(torch.from_numpy(logits), torch.from_numpy(logit_lens),
                        torch.from_numpy(labels), torch.from_numpy(label_lens)).numpy()
    assert np.isinf(got[0]) and np.isfinite(ref[0]) and ref[0] > 1e29
    np.testing.assert_allclose(got[1], ref[1], rtol=CTC_TOL)


# ---------------------------------------------------------------------------
# Optimizer, freeze mask
# ---------------------------------------------------------------------------


def test_anneal_schedule_matches_optax():
    spec = tstep.make_optimizer(learning_rate=1e-3, anneal=1.1, steps_per_epoch=10)
    sched = optax.exponential_decay(1e-3, 10, 1 / 1.1, staircase=True)
    for step in (0, 9, 10, 19, 25, 100):
        np.testing.assert_allclose(spec.lr_at(step), float(sched(step)), rtol=1e-6)
    assert tstep.make_optimizer(3e-4).lr_at(1234) == 3e-4
    with pytest.raises(ValueError, match="steps_per_epoch"):
        tstep.make_optimizer(anneal=1.1)
    leaf = torch.zeros(3, requires_grad=True)
    assert type(spec.build([leaf])) is torch.optim.Adam
    decayed = tstep.make_optimizer(1e-3, weight_decay=0.1).build([leaf])
    assert type(decayed) is torch.optim.AdamW
    assert decayed.defaults["betas"] == (0.9, 0.999) and decayed.defaults["eps"] == 1e-8


def test_freeze_mask_matches_jax():
    cfg = dict(model_name="f", rnn_hidden_size=8, rnn_layers=2, conv_layers=2)
    jparams = jds.init_params(JConfig(**cfg), seed=0)
    tparams = tds.init_params(TConfig(**cfg), seed=0)
    names = list(tckpt.flatten_tree(tparams))
    for n_frozen in (0, 1, 3, 4):
        ref = jflatten(jstep.freeze_mask(jparams, n_frozen, JConfig(**cfg)))
        got = dict(zip(names, tstep.freeze_mask(tparams, n_frozen, TConfig(**cfg))))
        assert got == {k: bool(v) for k, v in ref.items()}
    with pytest.raises(FreezingMoreLayersThanExist):
        tstep.freeze_mask(tparams, 5, TConfig(**cfg))


# ---------------------------------------------------------------------------
# Train steps from bridged parameters
# ---------------------------------------------------------------------------


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


def _bridged(seed=0, **cfg):
    jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
    sd = _randomize_bn(jckpt.state_dict_from_params(jds.init_params(jcfg, seed), jcfg))
    return (jcfg, jckpt.params_from_state_dict(sd, jcfg),
            tcfg, tckpt.params_from_state_dict(sd, tcfg))


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
    """The loss of the JAX wave train step (train/step.py:167-196, float32,
    no augmentation), for jax.value_and_grad."""
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


def _assert_tree_close(got: dict, ref: dict, rtol, what):
    assert sorted(got) == sorted(ref)
    for k in ref:
        scale = max(float(np.abs(ref[k]).max()), 1e-6)
        np.testing.assert_allclose(got[k], ref[k], atol=rtol * scale, rtol=0,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize(
    "bidirectional,remat", [(True, True), (True, False), (False, True), (False, False)]
)
def test_two_wave_train_steps_match_jax(bidirectional, remat):
    cfg = dict(model_name="s", rnn_hidden_size=32, rnn_layers=2, conv_layers=2,
               bidirectional=bidirectional)
    jcfg, jparams, tcfg, tparams = _bridged(**cfg)
    batch = _wave_batch(3, jcfg.num_classes)

    jopt = jstep.make_optimizer(LR)
    jstate = jstep.TrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))
    jfn = jax.jit(jstep.make_wave_train_step(jcfg, jopt, mixed_precision=False,
                                             remat=remat))
    ref_loss0, ref_grads = jax.jit(jax.value_and_grad(_jax_loss(jcfg, batch, remat)))(jparams)

    topt = tstep.make_optimizer(LR)
    tstate = tstep.train_state_from_params(tparams, topt, device="cpu")
    tfn = tstep.make_wave_train_step(tcfg, topt, mixed_precision=False, remat=remat)
    before = tckpt.flatten_tree(tstate.params)

    losses = {"jax": [], "torch": []}
    for k in range(2):
        jstate, jl = jfn(jstate, *(jnp.asarray(a) for a in batch))
        tstate, tl = tfn(tstate, *batch)
        losses["jax"].append(float(jl))
        losses["torch"].append(float(tl))
        if k == 0:
            grads = tckpt.flatten_tree(tds.map_params(lambda p: p.grad, tstate.params))
            _assert_tree_close(grads, jflatten(ref_grads), GRAD_RTOL, "gradient")
        ref = jflatten(jstate.params)
        got = tckpt.flatten_tree(tstate.params)
        assert sorted(got) == sorted(ref)
        diff = np.concatenate([np.abs(got[n] - ref[n]).ravel() for n in ref])
        assert diff.max() <= 2.0 * LR * (k + 1) * 1.05
        assert diff.mean() <= PARAM_MEAN * LR
    np.testing.assert_allclose(losses["torch"][0], float(ref_loss0), atol=LOSS_TOL)
    np.testing.assert_allclose(losses["torch"], losses["jax"], atol=LOSS_TOL)
    assert losses["torch"][1] < losses["torch"][0]
    assert tstate.step == 2 and int(jstate.step) == 2

    # every leaf is trained, the BN running statistics included: they move,
    # and as in the JAX package
    after, ref = tckpt.flatten_tree(tstate.params), jflatten(jstate.params)
    for name in ("conv.0.bn_mean", "conv.1.bn_var", "rnns.1.bn.mean", "fc_bn.var"):
        moved = np.abs(after[name] - before[name])
        assert moved.max() > 0.5 * LR, name
        np.testing.assert_allclose(np.sign(after[name] - before[name]),
                                   np.sign(ref[name] - before[name]), err_msg=name)


def test_mixed_precision_step_trains_float32_masters():
    """bf16 matmul weights inside the graph, float32 masters and gradients;
    the conv stack stays float32."""
    cfg = TConfig(model_name="mp", rnn_hidden_size=32, rnn_layers=2, conv_layers=2)
    opt = tstep.make_optimizer(LR)
    state = tstep.init_train_state(cfg, opt, seed=1, device="cpu")
    batch = _wave_batch(4, cfg.num_classes)
    ref_state = tstep.init_train_state(cfg, opt, seed=1, device="cpu")
    _, ref_loss = tstep.make_wave_train_step(cfg, opt, mixed_precision=False)(
        ref_state, *batch)
    fn = tstep.make_wave_train_step(cfg, opt, mixed_precision=True)
    losses = []
    for _ in range(3):
        state, loss = fn(state, *batch)
        losses.append(float(loss))
    for leaf in tstep.param_leaves(state.params):
        assert leaf.dtype == torch.float32 and leaf.grad.dtype == torch.float32
    # bf16 rounding of weights and streams moves a loss of order 10 a little
    np.testing.assert_allclose(losses[0], float(ref_loss), rtol=2e-2)
    assert losses[2] < losses[0]


def test_spectrogram_train_step_matches_jax():
    cfg = dict(model_name="sp", rnn_hidden_size=16, rnn_layers=1, conv_layers=1)
    jcfg, jparams, tcfg, tparams = _bridged(seed=2, **cfg)
    rng = np.random.default_rng(5)
    spect = rng.normal(size=(2, 1, 161, 40)).astype(np.float32)
    args = (spect, np.array([40, 32], np.int32),
            rng.integers(1, 33, size=(2, 6)).astype(np.int32), np.array([6, 4], np.int32))
    jopt = jstep.make_optimizer(LR)
    jstate = jstep.TrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))
    jstate, jl = jax.jit(jstep.make_train_step(jcfg, jopt))(
        jstate, *(jnp.asarray(a) for a in args))
    topt = tstep.make_optimizer(LR)
    tstate = tstep.train_state_from_params(tparams, topt, device="cpu")
    tstate, tl = tstep.make_train_step(tcfg, topt)(tstate, *args)
    np.testing.assert_allclose(float(tl), float(jl), atol=LOSS_TOL)
    got, ref = tckpt.flatten_tree(tstate.params), jflatten(jstate.params)
    diff = np.concatenate([np.abs(got[n] - ref[n]).ravel() for n in ref])
    assert diff.max() <= 2.0 * LR * 1.05 and diff.mean() <= PARAM_MEAN * LR


def test_frozen_leaves_and_the_weight_decay_divergence():
    """ROADMAP C1: with freeze_layers and weight_decay > 0 the JAX package
    zeroes the frozen gradients but ``optax.adamw`` still decays the frozen
    leaves; the port leaves them out of the update."""
    cfg = dict(model_name="fr", rnn_hidden_size=16, rnn_layers=2, conv_layers=1)
    jcfg, jparams, tcfg, tparams = _bridged(seed=3, **cfg)
    batch = _wave_batch(6, jcfg.num_classes)
    wd = 0.1

    jopt = jstep.make_optimizer(LR, weight_decay=wd)
    jstate = jstep.TrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))
    jmask = jstep.freeze_mask(jparams, 2, jcfg)  # the conv block and RNN layer 0
    jstate, _ = jax.jit(jstep.make_wave_train_step(
        jcfg, jopt, frozen_mask=jmask, mixed_precision=False))(
        jstate, *(jnp.asarray(a) for a in batch))

    topt = tstep.make_optimizer(LR, weight_decay=wd)
    tstate = tstep.train_state_from_params(tparams, topt, device="cpu")
    before = tckpt.flatten_tree(tstate.params)
    tmask = tstep.freeze_mask(tstate.params, 2, tcfg)
    tstate, _ = tstep.make_wave_train_step(
        tcfg, topt, frozen_mask=tmask, mixed_precision=False)(tstate, *batch)
    after, ref = tckpt.flatten_tree(tstate.params), jflatten(jstate.params)
    for name in before:
        frozen = name.startswith(("conv.0.", "rnns.0."))
        if frozen:
            np.testing.assert_array_equal(after[name], before[name], err_msg=name)
            # the JAX package shrank it by lr * weight_decay
            np.testing.assert_allclose(ref[name], before[name] * (1 - LR * wd),
                                       rtol=1e-5, atol=1e-8, err_msg=name)
        else:
            assert np.abs(after[name] - before[name]).max() > 0, name
            # trained leaves agree to first order in lr * weight_decay
            assert np.abs(after[name] - ref[name]).max() <= 2.0 * LR * 1.05, name


def test_train_state_copies_and_device_rules():
    cfg = TConfig(model_name="d", rnn_hidden_size=8, rnn_layers=1, conv_layers=1)
    params = tds.init_params(cfg, seed=0)
    opt = tstep.make_optimizer(LR)
    state = tstep.train_state_from_params(params, opt, device="cpu")
    leaf, master = params["fc"].weight, state.params["fc"].weight
    assert master.requires_grad and not leaf.requires_grad
    assert master.data_ptr() != leaf.data_ptr()  # training never edits the source
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tstep.init_train_state(cfg, opt)
    assert tstep._resolve_mixed_precision("auto", torch.device("cpu")) is False
    assert tstep._resolve_mixed_precision("auto", torch.device("cuda")) is True
    assert tstep._resolve_mixed_precision(True, torch.device("cpu")) is True
    with pytest.raises(ValueError, match="A6b"):
        tstep._resolve_mixed_precision(False, torch.device("cuda"))


# ---------------------------------------------------------------------------
# SpecAugment
# ---------------------------------------------------------------------------


def test_spec_augment_properties():
    rng = np.random.default_rng(0)
    b, f, t = 6, 161, 200
    spect = torch.from_numpy(rng.normal(size=(b, f, t)).astype(np.float32)) + 10.0
    lengths = torch.tensor([200, 150, 99, 40, 19, 1])
    kw = dict(n_freq_masks=2, freq_mask_width=27, n_time_masks=2, time_mask_ratio=0.05)
    out = taug.spec_augment(torch.Generator().manual_seed(3), spect, lengths, **kw)
    again = taug.spec_augment(torch.Generator().manual_seed(3), spect, lengths, **kw)
    other = taug.spec_augment(torch.Generator().manual_seed(4), spect, lengths, **kw)
    assert torch.equal(out, again)  # the same generator state, the same masks
    assert not torch.equal(out, other)
    assert out.shape == spect.shape and out.dtype == spect.dtype
    masked = (out != spect).numpy()
    assert masked.any()
    assert np.all(out.numpy()[masked] == 0.0)  # mask_value
    for row in range(b):
        n = int(lengths[row])
        m = masked[row]
        # a cell is masked by a whole frequency band or a whole time span
        bands = m.all(axis=1)
        spans = m[~bands].all(axis=0) if (~bands).any() else np.zeros(t, bool)
        assert np.array_equal(m, bands[:, None] | spans[None, :])
        assert bands.sum() <= kw["n_freq_masks"] * kw["freq_mask_width"]
        # time masks stay inside the valid frames, width <= int(ratio * length)
        assert not spans[n:].any()
        assert spans.sum() <= kw["n_time_masks"] * int(np.float32(n) * np.float32(0.05))
    # lengths 19 and 1: int(0.05 * length) == 0, so no time mask at all
    assert not masked[4][~masked[4].all(axis=1)].any()
    # widths reach their bounds over many draws and never pass them
    widths = []
    gen = torch.Generator().manual_seed(0)
    for _ in range(60):
        o = taug.spec_augment(gen, spect[:1], lengths[:1], n_freq_masks=1,
                              freq_mask_width=5, n_time_masks=1, time_mask_ratio=0.02)
        m = (o != spect[:1]).numpy()[0]
        bands = m.all(axis=1)
        widths.append((int(bands.sum()), int(m[~bands].all(axis=0).sum())))
    assert max(w for w, _ in widths) == 5 and min(w for w, _ in widths) == 0
    assert max(w for _, w in widths) == 4 and min(w for _, w in widths) == 0
    # off switches
    same = taug.spec_augment(torch.Generator().manual_seed(0), spect, lengths,
                             n_freq_masks=0, n_time_masks=0)
    assert torch.equal(same, spect)
