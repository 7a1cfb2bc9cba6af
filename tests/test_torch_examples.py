"""The gallery's twins (``danspeech_tpu_torch/examples``) on the CPU.

Each twin's ``main(argv)`` runs offline with ``--device cpu`` over inputs
this file writes under ``tmp_path``: seeded WAVs, small ``.pth`` packages
(2 conv, 2 GRU layers of width 32, ``tests/test_checkpoint.py``'s
``make_package``), an ARPA LM and a manifest. What a twin returns must
equal the port's API called directly on the same model and inputs, in
float32 exactly (``tests/test_torch_examples_jax.py`` holds two twins
against the JAX scripts). No test reaches the network:
``urllib.request.urlopen`` is patched to raise, and ``HOME`` points at an
empty directory, so that the zoo's cache is empty.
"""

import _thread
import contextlib
import os
import threading
import urllib.request
import wave

import numpy as np
import pytest
import torch

from danspeech_tpu.models.config import DeepSpeechConfig as JConfig
from danspeech_tpu_torch import MultiStreamTranscriber, Recognizer
from danspeech_tpu_torch.audio import load_audio, load_audio_pcm16, load_audio_wavPCM
from danspeech_tpu_torch.audio.dsp import energy_vad_segments
from danspeech_tpu_torch.engine import DanSpeechRecognizer
from danspeech_tpu_torch.examples import (
    batch_serving,
    device_beam_and_long_form,
    multi_stream_server,
    real_time_streaming_example,
    run_recognize,
    stream_example,
    train_finetune,
    video_transcribe_simulation,
)
from danspeech_tpu_torch.models.checkpoint import flatten_tree
from danspeech_tpu_torch.pretrained_models import CustomModel

from test_checkpoint import make_package
from test_torch_lm import arpa_text, write_text

RATE = 16000
BIDI = dict(model_name="gallery-bidi", rnn_hidden_size=32, rnn_layers=2, conv_layers=2)
UNI = dict(model_name="gallery-uni", rnn_hidden_size=32, rnn_layers=2, conv_layers=2,
           bidirectional=False, context=20, streaming_model=True)
CPU = ["--device", "cpu"]


def write_wav(path, samples):
    pcm = np.clip(np.asarray(samples), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(RATE)
        w.writeframes(pcm.tobytes())
    return str(path)


def speech(rng, seconds):
    return rng.normal(size=int(seconds * RATE)) * 3000.0


def silence(seconds):
    return np.zeros(int(seconds * RATE))


@pytest.fixture(autouse=True)
def offline(monkeypatch, tmp_path):
    def refuse(*a, **k):
        raise OSError("the network is not to be touched")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))


@pytest.fixture(autouse=True)
def one_thread():
    """The models here are small: one intra-op thread is as fast alone, and
    far faster when the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_inputs(root):
    """The seeded inputs under ``root``: 4 WAVs of 1-2 s in wavs/, a
    recording of 3 bursts and silences, a 2-phrase and a 1-phrase
    recording, two packages, an ARPA LM over letter words and a 4-row
    manifest."""
    rng = np.random.default_rng(40)
    wavs = root / "wavs"
    wavs.mkdir()
    paths = [write_wav(wavs / f"u{i}.wav", speech(rng, s))
             for i, s in enumerate((1.0, 1.5, 2.0, 1.25))]
    bursts = np.concatenate([silence(0.5), speech(rng, 1.5), silence(1.5), speech(rng, 2.0),
                             silence(1.5), speech(rng, 1.2), silence(1.0)])
    # a phrase ends after 5 quiet reads of 4096 samples (1.28 s)
    phrases = np.concatenate([silence(0.4), speech(rng, 0.9), silence(2.0),
                              speech(rng, 1.3), silence(2.0)])
    one = np.concatenate([silence(0.5), speech(rng, 1.6), silence(1.0)])
    packages = {}
    for name, cfg, seed in (("bidi", BIDI, 0), ("uni", UNI, 1)):
        packages[name] = str(root / f"{name}.pth")
        package = make_package(JConfig(**cfg), seed=seed)
        if name == "uni":
            spelling(package, one)
        torch.save(package, packages[name])
    labels = JConfig().labels
    letters = [c for c in labels if c not in "_ "]
    words = sorted({"".join(letters[i] for i in rng.integers(0, len(letters), n))
                    for n in rng.integers(1, 4, 40)})
    arpa = write_text(root / "lm.arpa", arpa_text(3, words, order=2))
    manifest = root / "train.csv"
    manifest.write_text("".join(f"wavs/{os.path.basename(p)},{t}\n" for p, t in
                                zip(paths, ("hej med dig", "tak", "det er nu", "og"))))
    return dict(root=root, wavs=str(wavs), paths=paths, arpa=arpa, manifest=str(manifest),
                bursts=write_wav(root / "bursts.wav", bursts),
                phrases=write_wav(root / "phrases.wav", phrases),
                one=write_wav(root / "one.wav", one), **packages)


def spelling(package, audio, letters="abcd", gain=4.0):
    """Make a random streaming model spell: its head's BatchNorm centres and
    scales the head's input features over ``audio`` (as the model computes
    them), and each of ``letters`` takes one of the four most varied
    features as its only logit input (every other logit 0, so a frame whose
    four features are all below their mean is blank). Its stream then has
    more than one character whatever the chunk boundaries, which the engine
    needs for a final (engine.py's ``len(iterating_transcript) > 1``, as in
    the JAX engine); left random, the head's argmax can stay on one letter
    for the whole stream."""
    from danspeech_tpu_torch.models import DeepSpeechModel
    from danspeech_tpu_torch.models import deepspeech as tds

    seen, head = [], tds.head
    tds.head = lambda params, x: (seen.append(x.detach().clone()), head(params, x))[1]
    try:
        Recognizer(model=DeepSpeechModel.load_model_package(package),
                   device="cpu").recognize(audio)
    finally:
        tds.head = head
    feats = torch.cat([x.reshape(-1, x.shape[-1]) for x in seen]).double()
    sd = package["state_dict"]
    sd["fc.0.module.0.running_mean"] = feats.mean(0).float()
    sd["fc.0.module.0.running_var"] = (feats.var(0) + 1e-3).float()
    sd["fc.0.module.0.weight"].fill_(1.0)
    sd["fc.0.module.0.bias"].zero_()
    weight = sd["fc.0.module.1.weight"]
    weight.zero_()
    for letter, k in zip(letters, feats.var(0).topk(len(letters)).indices.tolist()):
        weight[package["labels"].index(letter), k] = gain


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_inputs(tmp_path_factory.mktemp("gallery"))


def recognizer(path, **kw):
    return Recognizer(model=CustomModel(path), device="cpu", **kw)


def test_batch_serving_equals_the_api(data):
    out = batch_serving.main(["--wav-dir", data["wavs"], "--pth", data["bidi"], *CPU])
    waves = [load_audio_pcm16(p) for p in data["paths"]]
    assert out["clips"] == 4 and out["audio_s"] == sum(len(w) for w in waves) / RATE
    assert out["texts"] == recognizer(data["bidi"]).recognize_batch(waves)
    assert out["wall_s"] > 0 and out["audio_s_per_s"] > 0


def test_run_recognize_equals_the_api(data):
    out = run_recognize.main(["--wav", data["one"], "--pth", data["bidi"], "--arpa",
                              data["arpa"], *CPU])
    rec = recognizer(data["bidi"])
    audio = load_audio(data["one"])
    assert out["greedy"] == rec.recognize(audio)
    rec.update_decoder(lm=data["arpa"])
    assert out["beam"] == rec.recognize(audio)
    assert out["all_beams"] == rec.recognize(audio, show_all=True)
    assert out["lm_skipped"] is None and len(out["all_beams"]) > 1


def test_run_recognize_offline_skips_the_zoo_lm(data, capsys):
    """``--random-weights`` and no ``--arpa``: the DSL 3-gram is looked up
    in the (empty) cache only; the beam is skipped with a note naming it."""
    out = run_recognize.main(["--wav", data["one"], "--random-weights", *CPU])
    assert out["beam"] is None and "dsl_3gram.klm" in out["lm_skipped"]
    assert "beam decoding skipped" in capsys.readouterr().out
    assert not os.path.exists(os.path.expanduser("~/.danspeech_tpu"))


def test_device_beam_and_long_form_equals_the_api(data):
    import torch.distributed as dist

    out = device_beam_and_long_form.main(["--wav", data["one"], "--pth", data["bidi"],
                                          "--arpa", data["arpa"], *CPU])
    assert not dist.is_initialized()  # the twin destroyed the group it made
    audio = load_audio(data["one"])
    rec = recognizer(data["bidi"], lm=data["arpa"], alpha=1.0, beta=0.3)
    rec.update_decoder(beam_width=16)
    assert out["host"] == rec.recognize(audio)
    rec.update_decoder(backend="device")
    assert out["device"] == rec.recognize(audio)
    assert out["sharded"] == out["device"]  # bit-equal at world size 1
    long_form = recognizer(data["bidi"]).recognize_long_form(np.concatenate([audio] * 4))
    dist.destroy_process_group()
    assert out["long_form"] == long_form


def test_multi_stream_server_equals_the_api(data):
    argv = ["--wav-dir", data["wavs"], "--streams", "3", "--chunk-ms", "500",
            "--pth", data["uni"], *CPU]
    steps = multi_stream_server.main(argv)
    chunk = 16 * 500
    streams = multi_stream_server.session_streams(
        [load_audio_wavPCM(p) for p in data["paths"]], 3, chunk)
    ms = MultiStreamTranscriber(CustomModel(data["uni"]), n_streams=3, device="cpu")
    ref = [ms.step([s[i * chunk:(i + 1) * chunk] for s in streams], is_first=i == 0,
                   is_last=i == 4) for i in range(5)]
    assert steps == ref and len(steps) == 5 and all(len(s) == 3 for s in steps)


@contextlib.contextmanager
def watchdog(seconds=60.0):
    """A streaming twin that waits for more than its source holds is
    interrupted (it stops as on Ctrl-C, and the test's checks fail) rather
    than hanging the suite."""
    timer = threading.Timer(seconds, _thread.interrupt_main)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


def _record(monkeypatch, cls, name):
    calls = []
    inner = getattr(cls, name)

    def wrapper(self, *args, **kw):
        out = inner(self, *args, **kw)
        calls.append((args, kw, out))
        return out

    monkeypatch.setattr(cls, name, wrapper)
    return calls


def test_stream_example_equals_the_api(data, monkeypatch):
    """Two phrases: each transcript is ``recognize`` of the phrase the
    listener assembled, on a recognizer of its own."""
    calls = _record(monkeypatch, Recognizer, "recognize")
    with watchdog():
        texts = stream_example.main(["--wav", data["phrases"], "--phrases", "2", "--pth",
                                     data["bidi"], *CPU])
    assert len(texts) == 2 and len(calls) == 2
    monkeypatch.undo()
    rec = recognizer(data["bidi"])
    assert texts == [rec.recognize(args[0]) for args, _, _ in calls]
    # the phrase, its leading quiet reads and the 5 that end it
    assert 0.9 * RATE <= len(calls[0][0][0]) <= 3.5 * RATE


def test_real_time_streaming_example_equals_the_api(data, monkeypatch):
    """The chunks the paced listener handed ``streaming_transcribe``, sent
    again through the engine of a new recognizer: the same partials and
    final."""
    calls = _record(monkeypatch, DanSpeechRecognizer, "streaming_transcribe")
    with watchdog():
        events = real_time_streaming_example.main(
            ["--wav", data["one"], "--phrases", "1", "--pth", data["uni"],
             "--secondary-pth", data["bidi"], *CPU])
    monkeypatch.undo()
    assert events and events[-1][0] and sum(last for last, _ in events) == 1
    rec = recognizer(data["uni"])
    rec.enable_real_time_streaming(CustomModel(data["uni"]), string_parts=False,
                                   secondary_model=CustomModel(data["bidi"]))
    replay = [rec.danspeech_recognizer.streaming_transcribe(*args, **kw)
              for args, kw, _ in calls]
    assert replay == [out for _, _, out in calls]
    assert [t for _, t in events] == [out for out in replay if out]


def test_video_transcribe_simulation_equals_the_api(data):
    out = video_transcribe_simulation.main(
        [data["bursts"], "--pth", data["bidi"], "--arpa", data["arpa"], "--batch", "2",
         *CPU])
    audio = load_audio(data["bursts"])
    ranges = energy_vad_segments(audio, step=1024, energy_threshold=700.0,
                                 max_pause_steps=12, min_segment_samples=16000)
    assert out["ranges"] == ranges and len(ranges) == 3
    rec = recognizer(data["bidi"], lm=data["arpa"], alpha=video_transcribe_simulation.ALPHA,
                     beta=video_transcribe_simulation.BETA,
                     beam_width=video_transcribe_simulation.BEAM)
    ref = rec.recognize_batch([audio[a:b] for a, b in ranges[:2]])
    ref += rec.recognize_batch([audio[a:b] for a, b in ranges[2:]])
    assert out["segments"] == ref


def test_video_transcribe_simulation_offline_decodes_greedily(data, capsys):
    out = video_transcribe_simulation.main([data["bursts"], "--pth", data["bidi"], *CPU])
    assert "LM beam skipped" in capsys.readouterr().out
    audio = load_audio(data["bursts"])
    assert out["segments"] == recognizer(data["bidi"]).recognize_batch(
        [audio[a:b] for a, b in out["ranges"]])


def test_train_finetune_equals_the_api(data, tmp_path):
    """``--finetune-from`` a package with 2 layers frozen, one epoch: the
    exported parameters equal those of ``finetune`` called directly, and the
    frozen conv blocks equal the package's."""
    from danspeech_tpu_torch.train import export_model, finetune

    export = str(tmp_path / "twin.dsz")
    out = train_finetune.main([data["manifest"], "--finetune-from", data["bidi"],
                               "--freeze-layers", "2", "--epochs", "1", "--batch-size", "2",
                               "--checkpoint-dir", str(tmp_path / "ckpt"), "--export",
                               export, *CPU])
    assert out["exported"] == export and out["log"][0].startswith("epoch 0: loss")
    model = CustomModel(data["bidi"])
    state = finetune(model, data["manifest"], freeze_layers=2, epochs=1, batch_size=2,
                     learning_rate=3e-4, device="cpu", log=lambda line: None)
    direct = export_model(state, model.config, str(tmp_path / "direct.dsz"))
    got, ref = flatten_tree(CustomModel(export).params), flatten_tree(
        CustomModel(direct).params)
    assert sorted(got) == sorted(ref)
    assert all(np.array_equal(got[k], ref[k]) for k in got)
    start = flatten_tree(model.params)
    conv = [k for k in got if k.startswith("conv")]
    assert conv and all(np.array_equal(got[k], start[k]) for k in conv)
    assert any(not np.array_equal(got[k], start[k]) for k in got if k.startswith("rnns"))


def test_train_finetune_trains_a_fresh_model(data, tmp_path):
    out = train_finetune.main([data["manifest"], "--hidden", "16", "--layers", "1",
                               "--epochs", "1", "--batch-size", "4", "--checkpoint-dir",
                               str(tmp_path / "ckpt"), *CPU])
    assert out["exported"] is None and out["state"].step == 1
    assert (out["config"].rnn_hidden_size, out["config"].rnn_layers) == (16, 1)


@pytest.mark.parametrize("module,argv,flag", [
    (batch_serving, [], "--wav-dir"),
    (multi_stream_server, [], "--wav-dir"),
    (run_recognize, ["--random-weights"], "--wav"),
    (device_beam_and_long_form, [], "--wav"),
    (video_transcribe_simulation, ["no-such.wav", "--random-weights"], "AUDIO"),
])
def test_a_missing_input_names_its_option(module, argv, flag, capsys):
    with pytest.raises(SystemExit):
        module.main([*argv, *CPU])
    assert flag in capsys.readouterr().err
