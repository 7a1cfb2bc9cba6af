"""Training data pipeline, loop, checkpoints, export and CLI of the PyTorch
port against the JAX package (CPU, float32).

The manifests are temporary files over ``tests/data/clip_*.wav`` and seeded
WAVs; nothing outside the repository is read. A model exported by the port
is loaded by the JAX package and both give the same greedy transcript.
"""

import os
import wave

import numpy as np
import pytest
import torch

from danspeech_tpu import Recognizer as JRecognizer
from danspeech_tpu.models import DeepSpeechModel as JModel
from danspeech_tpu.models import checkpoint as jckpt
from danspeech_tpu.models.config import DeepSpeechConfig as JConfig
from danspeech_tpu.train import data as jdata
from danspeech_tpu_torch import Recognizer as TRecognizer
from danspeech_tpu_torch.audio import load_audio
from danspeech_tpu_torch.models import DeepSpeechModel as TModel
from danspeech_tpu_torch.models import checkpoint as tckpt
from danspeech_tpu_torch.models.config import DeepSpeechConfig as TConfig
from danspeech_tpu_torch.train import (
    GreedyEvaluator,
    SpeechDataset,
    continue_training,
    evaluate_greedy,
    export_model,
    finetune,
    train,
)
from danspeech_tpu_torch.train import data as tdata
from danspeech_tpu_torch.train import step as tstep
from danspeech_tpu_torch.train.__main__ import main as cli_main
from danspeech_tpu_torch.train.checkpoint import (
    latest_step,
    restore_train_state,
    save_train_state,
)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SMALL = dict(model_name="loop", rnn_hidden_size=32, rnn_layers=2, conv_layers=2)
QUIET = dict(log=lambda *a: None)


def _write_wav(path, samples):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.asarray(samples, "<i2").tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The two fixture clips (absolute paths) and three seeded WAVs
    (relative paths) behind one manifest with a header and a comment."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    lines = ["# a corpus", "file,transcript",
             f"{os.path.join(DATA, 'clip_mono.wav')},hej med dig",
             f"{os.path.join(DATA, 'clip_stereo.wav')},god dag, du"]
    for i, n in enumerate([5000, 21000, 9000]):
        _write_wav(d / f"u{i}.wav", rng.normal(size=n) * 1000)
        lines.append(f"u{i}.wav,{['tak', 'ja tak', 'nej'][i]}")
    man = d / "train.csv"
    man.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(man)


def test_manifest_and_batches_equal_the_jax_module(corpus):
    labels = TConfig().labels
    assert labels == JConfig().labels
    assert tdata.load_manifest(corpus) == jdata.load_manifest(corpus)
    tset = tdata.SpeechDataset.from_manifest(corpus, labels)
    jset = jdata.SpeechDataset.from_manifest(corpus, labels)
    assert len(tset) == len(jset) == 5
    assert [tuple(u) for u in tset.utterances] == [tuple(u) for u in jset.utterances]
    assert tdata.steps_per_epoch(5, 2) == jdata.steps_per_epoch(5, 2) == 3
    for epoch in (0, 3):
        got = list(tdata.batches(tset, 2, epoch=epoch, seed=1))
        ref = list(jdata.batches(jset, 2, epoch=epoch, seed=1))
        assert len(got) == len(ref) == 3
        for g, r in zip(got, ref):
            for field, a, b in zip(g._fields, g, r):
                assert a.dtype == b.dtype, field
                np.testing.assert_array_equal(a, b, err_msg=field)
    np.testing.assert_array_equal(
        tdata.encode_transcript("Hej, Verden! æøå", labels),
        jdata.encode_transcript("Hej, Verden! æøå", labels))
    batch = next(tdata.batches(tset, 2))
    assert tdata.shard_batch(batch) is batch  # no mesh: the batch itself
    with pytest.raises(NotImplementedError, match="A13"):
        tdata.shard_batch(batch, mesh=object())
    with pytest.raises(ValueError, match="STFT frame"):
        short = os.path.join(os.path.dirname(corpus), "short.wav")
        _write_wav(short, np.zeros(100))
        tdata.SpeechDataset([(short, "hej")], labels)


def test_train_two_epochs_checkpoints_and_validation(corpus, tmp_path):
    config = TConfig(**SMALL)
    seen = []
    lines = []
    state = train(
        config, corpus, epochs=2, batch_size=2, learning_rate=1e-3, anneal=1.1,
        augment=True, checkpoint_dir=str(tmp_path / "ck"), val_manifest=corpus,
        device="cpu", log=lines.append,
        stop_fn=lambda e, s, loss, wer: seen.append((e, s.step, loss, wer)) or False,
    )
    assert state.step == 6 and [s[:2] for s in seen] == [(0, 3), (1, 6)]
    assert all(np.isfinite(s[2]) and 0.0 <= s[3] for s in seen)
    assert seen[1][2] < seen[0][2]
    assert latest_step(str(tmp_path / "ck")) == 6
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000003", "step_00000006"]
    assert sum("val WER" in line for line in lines) == 2
    # the anneal divided the learning rate by 1.1 after the first epoch
    assert state.opt_state.param_groups[0]["lr"] == pytest.approx(1e-3 / 1.1)
    wer, texts = evaluate_greedy(state.params, config,
                                 SpeechDataset.from_manifest(corpus, config.labels))
    assert 0.0 <= wer and len(texts) == 5
    assert GreedyEvaluator(config)(state.params, SpeechDataset.from_manifest(
        corpus, config.labels), batch_size=2)[1] == texts


def test_early_stop(corpus):
    lines = []
    state = train(TConfig(**SMALL), corpus, epochs=5, batch_size=8, augment=False,
                  device="cpu", log=lines.append, stop_fn=lambda e, *a: e == 1)
    assert state.step == 2 and any("early stop after epoch 1" in s for s in lines)


def test_save_restore_round_trip(corpus, tmp_path):
    config = TConfig(**SMALL)
    state = train(config, corpus, epochs=1, batch_size=4, weight_decay=0.01,
                  augment=False, device="cpu", **QUIET)
    path = save_train_state(str(tmp_path), state, state.step)
    assert os.path.basename(path) == "step_00000002"
    opt = tstep.make_optimizer(3e-4, weight_decay=0.01)
    fresh = tstep.init_train_state(config, opt, seed=9, device="cpu")
    restored, step = restore_train_state(str(tmp_path), fresh)
    assert step == 2 and restored.step == 2
    ref, got = tckpt.flatten_tree(state.params), tckpt.flatten_tree(restored.params)
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    for a, b in zip(state.opt_state.state_dict()["state"].values(),
                    restored.opt_state.state_dict()["state"].values()):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(torch.as_tensor(a[key]), torch.as_tensor(b[key]))
    assert all(p.requires_grad for p in tstep.param_leaves(restored.params))
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path / "none"), fresh)
    other = tstep.init_train_state(TConfig(**dict(SMALL, rnn_layers=1)), opt, device="cpu")
    with pytest.raises(ValueError, match="another parameter tree"):
        restore_train_state(str(tmp_path), other)


def test_continue_training_resumes_at_the_right_epoch(corpus, tmp_path):
    config = TConfig(**SMALL)
    ckpt = str(tmp_path / "ck")
    first = train(config, corpus, epochs=2, batch_size=4, anneal=None, augment=False,
                  checkpoint_dir=ckpt, device="cpu", **QUIET)
    seen = []
    state = continue_training(config, corpus, ckpt, epochs=4, batch_size=4, anneal=None,
                              augment=False, device="cpu", log=seen.append)
    assert any("resumed step 4 (epoch 2)" in s for s in seen)
    # epochs 2 and 3 ran (0 and 1 were already done)
    assert sum("epoch 2:" in s or "epoch 3:" in s for s in seen) == 2
    assert not any("epoch 0:" in s or "epoch 1:" in s for s in seen)
    assert state.step == 8 and latest_step(ckpt) == 8

    # a resumed run continues the run it resumes: the same two more epochs
    # in one go from the same seed end at the same parameters
    whole = train(config, corpus, epochs=4, batch_size=4, anneal=None, augment=False,
                  device="cpu", **QUIET)
    assert first.step == 4
    ref, got = tckpt.flatten_tree(whole.params), tckpt.flatten_tree(state.params)
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], atol=1e-6, err_msg=name)


def test_finetune_freezes_and_leaves_the_model_alone(corpus):
    config = TConfig(**SMALL)
    model = TModel.init_random(config, seed=4)
    source = tckpt.flatten_tree(model.params)
    state = finetune(model, corpus, freeze_layers=3, epochs=1, batch_size=4,
                     augment=False, device="cpu", **QUIET)
    after = tckpt.flatten_tree(state.params)
    for name, value in tckpt.flatten_tree(model.params).items():
        np.testing.assert_array_equal(value, source[name], err_msg=name)
    for name in source:
        # two conv blocks and the first RNN layer are frozen
        frozen = name.startswith(("conv.", "rnns.0."))
        assert np.array_equal(after[name], source[name]) == frozen, name


def test_export_loads_in_the_jax_package_with_the_same_transcript(corpus, tmp_path):
    config = TConfig(**SMALL)
    state = train(config, corpus, epochs=1, batch_size=4, augment=False, device="cpu",
                  **QUIET)
    path = export_model(state, config, str(tmp_path / "out" / "trained.dsz"))
    jconfig, jparams = jckpt.load_checkpoint(path)
    assert jconfig.to_dict() == config.to_dict()
    ref = tckpt.state_dict_from_params(state.params, config)
    got = jckpt.state_dict_from_params(jparams, jconfig)
    for name in ref:
        np.testing.assert_array_equal(np.asarray(got[name]), ref[name], err_msg=name)
    audio = load_audio(os.path.join(DATA, "clip_mono.wav"))
    ours = TRecognizer(model=TModel.load_model(path), device="cpu").recognize(audio)
    theirs = JRecognizer(model=JModel.load_model(path)).recognize(audio)
    assert isinstance(ours, str) and ours == theirs


def test_cli_trains_and_exports_on_the_cpu(corpus, tmp_path, capsys):
    ckpt, out = tmp_path / "ckpts", tmp_path / "model.dsz"
    cli_main([
        "--manifest", corpus, "--val-manifest", corpus, "--epochs", "2",
        "--batch-size", "8", "--lr", "1e-3", "--hidden", "32", "--rnn-layers", "1",
        "--conv-layers", "1", "--checkpoint-dir", str(ckpt), "--export", str(out),
        "--no-augment", "--device", "cpu",
    ])
    assert latest_step(str(ckpt)) == 2  # 1 step/epoch x 2 epochs
    assert "exported" in capsys.readouterr().out
    model = TModel.load_model(str(out))
    assert model.config.rnn_hidden_size == 32 and model.config.rnn_layers == 1
    # finetune and continue through the CLI
    cli_main(["--manifest", corpus, "--epochs", "1", "--batch-size", "8",
              "--finetune-from", str(out), "--freeze-layers", "1", "--no-augment",
              "--unidirectional", "--device", "cpu"])
    cli_main(["--manifest", corpus, "--epochs", "3", "--batch-size", "8",
              "--hidden", "32", "--rnn-layers", "1", "--conv-layers", "1",
              "--resume-dir", str(ckpt), "--no-augment", "--device", "cpu"])
    assert "resumed step 2 (epoch 2)" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="A13"):
        cli_main(["--manifest", corpus, "--data-parallel", "--device", "cpu"])


def test_cli_finetunes_from_a_pth_package(corpus, tmp_path, capsys):
    """--finetune-from takes a zoo .pth package (the original key layout,
    written with torch.save): the run starts from its weights and exports
    a model of its shape."""
    from danspeech_tpu.models.config import DeepSpeechConfig as JConfig
    from test_checkpoint import make_package

    package = make_package(JConfig(model_name="zoo", rnn_hidden_size=16,
                                   rnn_layers=1, conv_layers=1), seed=2)
    pth, out = tmp_path / "zoo.pth", tmp_path / "tuned.dsz"
    torch.save(package, str(pth), _use_new_zipfile_serialization=False)
    start = TModel.load_model(str(pth))
    cli_main(["--manifest", corpus, "--epochs", "1", "--batch-size", "8",
              "--finetune-from", str(pth), "--freeze-layers", "1", "--no-augment",
              "--export", str(out), "--device", "cpu"])
    assert "exported" in capsys.readouterr().out
    tuned = TModel.load_model(str(out))
    assert tuned.config.to_dict() == start.config.to_dict()
    # the frozen conv layer kept the package's weights; the head moved
    torch.testing.assert_close(tuned.params["conv"][0].weight,
                               start.params["conv"][0].weight, rtol=0, atol=0)
    assert not torch.equal(tuned.params["fc"].weight, start.params["fc"].weight)


def test_train_refusals(corpus):
    config = TConfig(**SMALL)
    if not torch.cuda.is_available():
        # device=None means CUDA: without a GPU the loop raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train(config, corpus, epochs=1, **QUIET)
    with pytest.raises(NotImplementedError, match="A13"):
        train(config, corpus, epochs=1, mesh=object(), device="cpu", **QUIET)
    # the mesh refusal holds for every rnn_type, and none is refused itself
    for rnn_type in ("lstm", "rnn"):
        other = TConfig(**dict(SMALL, rnn_type=rnn_type, rnn_hidden_size=8))
        with pytest.raises(NotImplementedError, match="A13"):
            train(other, corpus, epochs=1, mesh=object(), device="cpu", **QUIET)
        state = train(other, corpus, epochs=1, batch_size=8, augment=False,
                      device="cpu", **QUIET)
        assert state.step == 1
