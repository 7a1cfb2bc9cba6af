"""The port's mesh and data parallelism (danspeech_tpu_torch/parallel:
mesh.py, sharding.py, batch.py, and the training hooks) on spawned gloo
ranks on the CPU, against the port's single-process paths and the JAX
package. Twin of tests/test_parallel.py and tests/test_dp_scaling.py.

Each world size runs all its cases in one spawned group (a module-scoped
fixture); the tests below then assert case by case. Top-level imports stay
torch, numpy and the port: the spawned ranks import this module.
"""

import os
import wave

import numpy as np
import pytest
import torch

from torch_ranks import jax_model, jax_state_dict, port_model, run_ranks

DATA = os.path.join(os.path.dirname(__file__), "data")
CFG = dict(model_name="mesh-test", rnn_hidden_size=64, rnn_layers=2, conv_layers=2)
TRAIN_CFG = dict(model_name="mesh-train", rnn_hidden_size=32, rnn_layers=2,
                 conv_layers=1)
LR = 1e-3
# how far a sharded run's update may differ from the unsharded one's, per
# leaf (relative L2) and per element: the data axis sums the gradients in
# another order, and Adam's g / (|g| + eps) lifts that rounding where |g| is
# tiny (at most 6.4e-5 relative, 4.3e-5 absolute, seen on the CPU). A leaf
# left unupdated, or updated from stale Adam state, is off by about LR.
UPDATE_RTOL = 1e-3
UPDATE_ATOL = LR / 10
QUIET = dict(log=lambda *a: None)


def _waves():
    from danspeech_tpu_torch.audio import load_audio

    clips = [load_audio(os.path.join(DATA, f))[:32000]
             for f in ("clip_mono.wav", "clip_stereo.wav")]
    rng = np.random.default_rng(21)
    return clips + [(rng.normal(size=n) * 2000).astype(np.float32)
                    for n in (9600, 14000, 16000, 12000, 8000)]


def _train_batch(config):
    """8 rows, the last three padding (weight 0): over 4 data ranks rank 3
    holds no weight at all and rank 2 half, so a mean of per-rank means
    is wrong."""
    from danspeech_tpu_torch.train.data import Batch

    rng = np.random.default_rng(8)
    rows, real, maxlen = 8, 5, 12000
    waves = np.zeros((rows, maxlen), np.float32)
    wave_lengths = np.full(rows, 8000, np.int32)
    labels = np.zeros((rows, 6), np.int32)
    label_lengths = np.ones(rows, np.int32)
    weights = np.zeros(rows, np.float32)
    for r in range(real):
        n = int(rng.integers(6000, maxlen + 1))
        waves[r, :n] = rng.normal(size=n) * 2000
        wave_lengths[r] = n
        k = int(rng.integers(3, 7))
        labels[r, :k] = rng.integers(1, config.num_classes, size=k)
        label_lengths[r] = k
        weights[r] = 1.0
    return Batch(waves, wave_lengths, labels, label_lengths, weights)


def _flat(params) -> dict:
    from danspeech_tpu_torch.models.checkpoint import flatten_tree

    return flatten_tree(params)


def _step(train_sd, batch, mesh=None):
    """One wave train step from the state dict's weights: (loss, params)."""
    from danspeech_tpu_torch.models.checkpoint import params_from_state_dict
    from danspeech_tpu_torch.models.config import DeepSpeechConfig
    from danspeech_tpu_torch.train import data as tdata
    from danspeech_tpu_torch.train import step as tstep

    config = DeepSpeechConfig(**TRAIN_CFG)
    spec = tstep.make_optimizer(LR)
    params = params_from_state_dict(train_sd, config)
    state = tstep.train_state_from_params(params, spec, device="cpu" if mesh is None
                                          else None, mesh=mesh)
    step = tstep.make_wave_train_step(config, spec, augment=False,
                                      mixed_precision=False, mesh=mesh)
    state, loss = step(state, *tdata.shard_batch(batch, mesh))
    return float(loss), _flat(state.params), _moments(state.opt_state.state_dict())


def _initial_params(train_sd=None) -> dict:
    """The parameters a step starts from: the state dict's, or (None) those
    of train(seed=0)."""
    from danspeech_tpu_torch.models.checkpoint import params_from_state_dict
    from danspeech_tpu_torch.models.config import DeepSpeechConfig
    from danspeech_tpu_torch.train import init_train_state, make_optimizer

    config = DeepSpeechConfig(**TRAIN_CFG)
    if train_sd is not None:
        return _flat(params_from_state_dict(train_sd, config))
    return _flat(init_train_state(config, make_optimizer(LR), seed=0, device="cpu").params)


def _assert_same_update(params, ref_params, before, what):
    """The update a run made (parameters after minus before) equals the
    reference run's, leaf by leaf, far below the learning rate."""
    assert sorted(params) == sorted(ref_params)
    for name, ref in ref_params.items():
        want = ref - before[name]
        assert np.abs(want).max() > LR / 2, f"{what} {name}: the reference did not move"
        got = params[name] - before[name]
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        assert rel <= UPDATE_RTOL, f"{what} {name}: update off by {rel:.2e} relative"
        np.testing.assert_allclose(got, want, rtol=0, atol=UPDATE_ATOL,
                                   err_msg=f"{what} {name}")


def _moments(opt_state) -> dict:
    """Adam's state per leaf index as numpy (a sharded optimizer's state
    dict is the whole one, gathered over the model axis)."""
    return {i: {k: np.asarray(v) for k, v in st.items()}
            for i, st in opt_state["state"].items()}


def _write_manifest(tmp, n_utts=8):
    rng = np.random.default_rng(5)
    words = ["hej", "med", "dig", "tak", "nu"]
    lines = []
    for i in range(n_utts):
        path = os.path.join(tmp, f"utt{i}.wav")
        samples = np.clip(rng.normal(size=int(rng.integers(6000, 14000))) * 3000,
                          -32768, 32767).astype(np.int16)
        with wave.open(path, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes(samples.tobytes())
        text = " ".join(words[j] for j in rng.integers(0, len(words), 2))
        lines.append(f"{path},{text}")
    manifest = os.path.join(tmp, "train.csv")
    with open(manifest, "w") as f:
        f.write("\n".join(lines) + "\n")
    return manifest


def _train_loop(manifest, mesh=None, checkpoint_dir=None):
    from danspeech_tpu_torch.models.config import DeepSpeechConfig
    from danspeech_tpu_torch.train import train

    state = train(DeepSpeechConfig(**TRAIN_CFG), manifest, epochs=1, batch_size=4,
                  augment=False, learning_rate=LR, seed=0, mesh=mesh,
                  checkpoint_dir=checkpoint_dir,
                  device="cpu" if mesh is None else None, **QUIET)
    return state.step, _flat(state.params)


def _collective_cases(mesh):
    """What each helper returns on this rank, for the JAX semantics."""
    from danspeech_tpu_torch.parallel import mesh as pm

    out = {}
    for axis in (pm.DATA_AXIS, pm.MODEL_AXIS):
        i = pm.axis_index(mesh, axis)
        x = torch.full((2, 3), float(i + 1))
        out[axis] = {
            "index": i, "size": mesh.size(axis),
            "psum": pm.psum(x, mesh, axis).numpy(),
            "gather": pm.all_gather(x, mesh, axis, dim=1).numpy(),
            "up": pm.ppermute(x, mesh, axis, +1).numpy(),
            "down": pm.ppermute(x, mesh, axis, -1).numpy(),
            "bcast": pm.broadcast(x, mesh, axis, mesh.size(axis) - 1).numpy(),
        }
    return out


def _dp_rank(rank, n, sd, train_sd, waves, batch, manifest, ckpt_root):
    from danspeech_tpu_torch.decode.greedy import GreedyDecoder
    from danspeech_tpu_torch.parallel import ShardedTranscriber, make_mesh
    from danspeech_tpu_torch.parallel import mesh as pm

    model = port_model(CFG, sd)
    mesh = make_mesh(device="cpu")
    out = {"mesh": (mesh.size("data"), mesh.size("model"), mesh.transport)}
    tr = ShardedTranscriber(model, mesh)
    out["transcripts"] = tr.transcribe(waves, GreedyDecoder(model.labels, blank_index=0))
    out["probs"], out["lens"] = tr.acoustic_probs(waves)
    before = pm.collective_calls()
    lo, probs, _ = tr.local_acoustic_probs(waves)
    out["forward_collectives"] = pm.collective_calls() - before
    out["local_rows"] = (lo, probs.shape[0])
    out["collectives"] = _collective_cases(mesh)
    out["step"] = _step(train_sd, batch, mesh)
    out["train_loop"] = _train_loop(manifest, mesh)
    if n == 4:
        mesh22 = make_mesh(n_data=2, n_model=2, device="cpu")
        tp = ShardedTranscriber(model, mesh22)
        out["tp_mode"] = tp.tp_mode
        out["tp_probs"] = tp.acoustic_probs(waves)[0]
        out["collectives22"] = _collective_cases(mesh22)
        out["step22"] = _step(train_sd, batch, mesh22)
        out["train_loop22"] = _train_loop(manifest, mesh22,
                                          checkpoint_dir=os.path.join(ckpt_root, "22"))
        try:
            make_mesh(n_data=3, n_model=2, device="cpu")
        except ValueError as e:
            out["bad_mesh"] = str(e)
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    sd = jax_state_dict(CFG, seed=31, bn_seed=32)
    train_sd = jax_state_dict(TRAIN_CFG, seed=7)
    from danspeech_tpu_torch.models.config import DeepSpeechConfig

    batch = _train_batch(DeepSpeechConfig(**TRAIN_CFG))
    return dict(tmp=tmp, sd=sd, train_sd=train_sd, waves=_waves(), batch=batch,
                manifest=_write_manifest(str(tmp)))


@pytest.fixture(scope="module")
def ranks(setup):
    """world size -> the ranks' results of :func:`_dp_rank`."""
    s = setup
    return {n: run_ranks(_dp_rank, n, s["tmp"], s["sd"], s["train_sd"], s["waves"],
                         s["batch"], s["manifest"], str(s["tmp"])) for n in (2, 4)}


@pytest.fixture(scope="module")
def singles(setup):
    """The port's single-process results: per-row recognize, the batch
    forward's probabilities, the unsharded step and loop."""
    from danspeech_tpu_torch import Recognizer

    model = port_model(CFG, setup["sd"])
    rec = Recognizer(model=model, device="cpu")
    return {
        "recognize": [rec.recognize(w) for w in setup["waves"]],
        "step": _step(setup["train_sd"], setup["batch"]),
        "step_before": _initial_params(setup["train_sd"]),
        "train_loop": _train_loop(setup["manifest"]),
        "train_loop_before": _initial_params(),
    }


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_transcriber_matches_recognize(ranks, singles, setup, n):
    """ShardedTranscriber over n data ranks: every rank returns the
    transcripts of Recognizer.recognize row by row, and the JAX package's."""
    from danspeech_tpu.recognizer import Recognizer as JRecognizer

    jrec = JRecognizer(model=jax_model(CFG, setup["sd"]), compute_dtype="float32")
    expected = singles["recognize"]
    assert expected == jrec.recognize_batch(setup["waves"])
    for out in ranks[n]:
        assert out["mesh"] == (n, 1, "gloo")
        assert out["transcripts"] == expected
        np.testing.assert_array_equal(out["probs"], ranks[n][0]["probs"])


def test_model_axis_forward_matches_replicated(ranks):
    """On a (2, 2) mesh the rows run tensor-parallel (direction mode on the
    bidirectional model) and equal the replicated forward."""
    for out in ranks[4]:
        assert out["tp_mode"] == "direction"
        np.testing.assert_allclose(out["tp_probs"], out["probs"], atol=2e-5, rtol=0)


@pytest.mark.parametrize("layout", ["4x1", "2x2"])
def test_sharded_train_step_matches_unsharded(ranks, singles, layout):
    """One step over 4 data ranks, or 2 data x 2 model ranks (Adam's state
    sharded over the model axis), equals the unsharded step on every rank:
    the weighted mean over the global batch, gradients summed over the data
    axis, every leaf's update from its owner's Adam state."""
    ref_loss, ref_params, ref_moments = singles["step"]
    key = "step" if layout == "4x1" else "step22"
    for rank, out in enumerate(ranks[4]):
        loss, params, moments = out[key]
        assert abs(loss - ref_loss) <= 1e-4 * max(1.0, abs(ref_loss))
        _assert_same_update(params, ref_params, singles["step_before"],
                            f"{layout} rank {rank}")
        # Adam's state, gathered from its shards, is the unsharded one's
        assert sorted(moments) == sorted(ref_moments)
        for i, ref in ref_moments.items():
            np.testing.assert_array_equal(moments[i]["step"], ref["step"])
            for k in ("exp_avg", "exp_avg_sq"):
                # the data axis sums the gradients in another order: float32
                # rounding at the scale of the leaf's largest entry
                scale = float(np.abs(ref[k]).max())
                np.testing.assert_allclose(moments[i][k], ref[k], rtol=1e-3,
                                           atol=1e-5 * scale, err_msg=f"{i} {k}")


def test_padding_weights_defeat_a_mean_of_rank_means(setup, singles):
    """The batch of the step above: a plain mean of the 4 ranks' weighted
    means differs from the global weighted mean, so the equality above
    holds only because the step does not take it."""
    from danspeech_tpu_torch.features.spectrogram import AudioParser
    from danspeech_tpu_torch.models import deepspeech as ds
    from danspeech_tpu_torch.models.checkpoint import params_from_state_dict
    from danspeech_tpu_torch.models.config import DeepSpeechConfig
    from danspeech_tpu_torch.ops import stft as stft_ops
    from danspeech_tpu_torch.train.ctc import ctc_loss

    config = DeepSpeechConfig(**TRAIN_CFG)
    b = setup["batch"]
    # the per-row losses of the unsharded model, as the step computes them
    params = params_from_state_dict(setup["train_sd"], config)
    parser = AudioParser(config.audio_conf)
    spect, frames = stft_ops.batched_log_spectrogram(
        torch.from_numpy(b.waves), torch.from_numpy(b.wave_lengths), parser.n_fft,
        parser.hop_length, parser.window)
    logits, out_lens = ds.forward(params, config, spect[:, None], frames, softmax=False)
    per = (ctc_loss(logits, out_lens, torch.from_numpy(b.labels),
                    torch.from_numpy(b.label_lengths), blank_id=0)
           / torch.from_numpy(b.label_lengths).float()).detach().numpy()
    w = b.row_weights
    global_mean = float((per * w).sum() / max(w.sum(), 1e-6))
    assert abs(global_mean - singles["step"][0]) < 1e-4
    rank_means = [float((per[r:r + 2] * w[r:r + 2]).sum() / max(w[r:r + 2].sum(), 1e-6))
                  for r in range(0, 8, 2)]
    assert abs(np.mean(rank_means) - global_mean) > 1e-2


@pytest.mark.parametrize("n", [2, 4])
def test_dp_forward_runs_no_collective(ranks, n):
    """The forward of a rank's rows calls no collective helper: data
    parallelism scales with no exchange inside the forward."""
    for rank, out in enumerate(ranks[n]):
        assert out["forward_collectives"] == 0
        assert out["local_rows"] == (rank * (8 // n), 8 // n)


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_have_jax_semantics(ranks, n):
    """axis_index, psum, all_gather (tiled), ppermute (non-wrapping: zeros at
    the boundary) and broadcast, on the data axis and the one-rank model
    axis; on (2, 2) along both axes."""
    cases = [("collectives", ranks[n])]
    if n == 4:
        cases.append(("collectives22", ranks[n]))
    for key, outs in cases:
        for out in outs:
            for axis, got in out[key].items():
                m, i = got["size"], got["index"]
                one = np.ones((2, 3), np.float32)
                np.testing.assert_array_equal(got["psum"], one * m * (m + 1) / 2)
                np.testing.assert_array_equal(
                    got["gather"], np.concatenate([one * (k + 1) for k in range(m)], 1))
                np.testing.assert_array_equal(got["up"], one * i if i > 0 else 0 * one)
                np.testing.assert_array_equal(
                    got["down"], one * (i + 2) if i < m - 1 else 0 * one)
                np.testing.assert_array_equal(got["bcast"], one * m)
    assert sorted((o["collectives22"]["data"]["index"], o["collectives22"]["model"]["index"])
                  for o in ranks[4]) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    if n == 4:
        assert "does not cover 4 ranks" in ranks[4][0]["bad_mesh"]


def test_shard_batch_gives_each_rank_its_rows(setup):
    """shard_batch: the rank's contiguous slice of every field; a batch that
    does not split over the data axis raises."""
    from types import SimpleNamespace

    from danspeech_tpu_torch.train.data import shard_batch

    batch = setup["batch"]
    for n in (1, 2, 4, 8):
        for i in range(n):
            mesh = SimpleNamespace(size=lambda a, n=n: n, index=lambda a, i=i: i)
            got = shard_batch(batch, mesh)
            per = 8 // n
            for field, a, b in zip(batch._fields, got, batch):
                np.testing.assert_array_equal(a, b[i * per : (i + 1) * per], err_msg=field)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(batch, SimpleNamespace(size=lambda a: 3, index=lambda a: 0))


def test_train_over_a_mesh_equals_unsharded(ranks, singles):
    """train(mesh=) for one epoch on a seeded manifest (batch 4 over 2 and
    4 data ranks, and on the (2, 2) mesh) takes the unsharded run's steps,
    and every rank's parameters move as the unsharded run's do."""
    ref_steps, ref_params = singles["train_loop"]
    assert ref_steps == 2
    for key, n in (("train_loop", 2), ("train_loop", 4), ("train_loop22", 4)):
        for rank, out in enumerate(ranks[n]):
            steps, params = out[key]
            assert steps == ref_steps
            _assert_same_update(params, ref_params, singles["train_loop_before"],
                                f"{key} n={n} rank {rank}")


def test_train_over_a_mesh_checkpoints_from_rank_0(ranks, setup, singles):
    """On the (2, 2) mesh only rank 0 wrote the checkpoint; it holds the
    run's parameters and the whole of Adam's state, gathered from the model
    axis' shards, and an unsharded state restores from it."""
    from danspeech_tpu_torch.models.config import DeepSpeechConfig
    from danspeech_tpu_torch.train import init_train_state, make_optimizer
    from danspeech_tpu_torch.train.checkpoint import latest_step, restore_train_state

    ckpt = os.path.join(str(setup["tmp"]), "22")
    assert latest_step(ckpt) == 2
    like = init_train_state(DeepSpeechConfig(**TRAIN_CFG), make_optimizer(LR), device="cpu")
    state, step = restore_train_state(ckpt, like)
    assert step == 2 and state.step == 2
    got = _flat(state.params)
    for name, ref in ranks[4][0]["train_loop22"][1].items():
        np.testing.assert_array_equal(got[name], ref, err_msg=name)
    assert len(state.opt_state.state) == len(got)


@pytest.mark.parametrize("n_model", [1, 2, 4])
def test_param_placements_and_shards_equal_jax(setup, n_model):
    """param_pspecs places each leaf as the JAX package's PartitionSpecs do
    (the gate, hidden or class dim over "model"); shard_params gives each
    rank of the model axis its contiguous piece, and the pieces in rank
    order make the whole leaf."""
    from types import SimpleNamespace

    from danspeech_tpu.parallel.sharding import param_pspecs as jspecs
    from danspeech_tpu_torch.parallel import param_pspecs, shard_params
    from danspeech_tpu_torch.parallel.sharding import _walk

    model = port_model(CFG, setup["sd"])
    jtree = jax_model(CFG, setup["sd"]).params
    checked = []

    def same(spec, jspec):
        if spec is None or jspec is None:
            assert spec is None and jspec is None
        elif isinstance(spec, dict):
            assert sorted(spec) == sorted(jspec)
            for k in spec:
                same(spec[k], jspec[k])
        elif isinstance(spec, list) or type(spec).__name__ != "Placement":
            assert len(spec) == len(jspec)
            for a, b in zip(spec, jspec):
                same(a, b)
        else:
            axes = list(jspec)
            want = (None, None) if "model" not in axes else ("model", axes.index("model"))
            assert tuple(spec) == want
            checked.append(spec)

    same(param_pspecs(model.params), jspecs(jtree))
    assert len(checked) == len(_flat(model.params))
    full = []
    _walk(lambda leaf, spec: full.append((leaf, spec)), model.params,
          param_pspecs(model.params))
    pieces = []
    for k in range(n_model):
        mesh = SimpleNamespace(size=lambda a, n=n_model: n, index=lambda a, k=k: k,
                               device=torch.device("cpu"))
        got = []
        _walk(lambda leaf, spec: got.append(leaf), shard_params(mesh, model.params),
              param_pspecs(model.params))
        pieces.append(got)
    for i, (leaf, spec) in enumerate(full):
        parts = [p[i] for p in pieces]
        if spec.axis is None or n_model == 1:
            for part in parts:
                torch.testing.assert_close(part, leaf, rtol=0, atol=0)
        else:
            torch.testing.assert_close(torch.cat(parts, dim=spec.dim), leaf, rtol=0, atol=0)
