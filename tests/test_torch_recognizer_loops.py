"""The VAD listen loops and microphone calibrations of the PyTorch port's
``Recognizer`` against the JAX package's (CPU).

Both recognizers read the same scripted source (``tests/test_recognizer_loops.py``'s
``FakeSource``: deterministic 16-bit PCM, read at disk speed): the blocking
``listen`` (a phrase, the timeout on silence, the phrase time limit, the
dynamic threshold's decay), silence-segmented ``streaming`` (one transcript
per phrase, equal to ``recognize`` of its samples and to the JAX
recognizer's), ``adjust_for_speech``, ``adjust_for_ambient_noise`` and
``update_stream_parameters``. ``listen_stream``, ``listen_in_background``
and ``real_time_streaming`` are covered by ``tests/test_torch_streaming.py``.
"""

import time

import numpy as np
import pytest

from danspeech_tpu.audio.io import SpeechSource as JSpeechSource
from danspeech_tpu.audio.io import _PCMStream as JPCMStream
from danspeech_tpu.models import DeepSpeechModel as JModel
from danspeech_tpu.models import checkpoint as jckpt
from danspeech_tpu.models import deepspeech as jds
from danspeech_tpu.models.config import DeepSpeechConfig as JConfig
from danspeech_tpu.recognizer import Recognizer as JRecognizer
from danspeech_tpu_torch import Recognizer as TRecognizer
from danspeech_tpu_torch.audio.dsp import rms
from danspeech_tpu_torch.audio.io import AudioData, SpeechSource, _PCMStream
from danspeech_tpu_torch.errors import WaitTimeoutError
from danspeech_tpu_torch.models import DeepSpeechModel as TModel
from danspeech_tpu_torch.models import checkpoint as tckpt
from danspeech_tpu_torch.models.config import DeepSpeechConfig as TConfig

RATE = 16000
CHUNK = 1024
LOOPS = dict(model_name="loops-test", rnn_hidden_size=32, rnn_layers=2, conv_layers=2)


class _IdleAtEnd:
    """A stream that, once its data is read, waits a few milliseconds before
    each empty read, as a quiet capture device would, rather than handing
    the background listener empty reads in a tight loop."""

    def __init__(self, inner):
        self.inner = inner

    def read(self, size):
        data = self.inner.read(size)
        if not data:
            time.sleep(0.005)
        return data


def fake_source(waveform, base=SpeechSource, stream_cls=_PCMStream, chunk=CHUNK,
                idle_at_end=False):
    """An in-memory SpeechSource over a [-1, 1] waveform (16-bit mono PCM)."""
    pcm = (np.clip(waveform, -1.0, 1.0) * 32767).astype("<i2").tobytes()

    class FakeSource(base):
        def __init__(self):
            self.sampling_rate, self.sampling_width, self.chunk = RATE, 2, chunk
            self.stream = None

        def __enter__(self):
            self.stream = stream_cls(pcm, 2)
            if idle_at_end:
                self.stream = _IdleAtEnd(self.stream)
            return self

        def __exit__(self, *exc):
            self.stream = None

    return FakeSource()


def jax_source(waveform, idle_at_end=False):
    return fake_source(waveform, JSpeechSource, JPCMStream, idle_at_end=idle_at_end)


def silence(seconds):
    return np.zeros(int(seconds * RATE), np.float32)


def speech(seconds, seed=0, amp=0.3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, int(seconds * RATE)) * amp).astype(np.float32)


def _tuned(rec):
    rec.dynamic_energy_threshold = False  # deterministic endpointing
    rec.energy_threshold = 1000
    return rec


def recognizers(models=None):
    jm, tm = models if models else (None, None)
    return (_tuned(TRecognizer(model=tm, device="cpu")),
            _tuned(JRecognizer(model=jm, compute_dtype="float32")))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JConfig(**LOOPS), TConfig(**LOOPS)
    sd = jckpt.state_dict_from_params(jds.init_params(jcfg, 21), jcfg)
    rng = np.random.default_rng(22)
    for k in list(sd):
        if k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, sd[k].shape).astype(np.float32)
    return (JModel(jcfg, jckpt.params_from_state_dict(sd, jcfg)),
            TModel(tcfg, tckpt.params_from_state_dict(sd, tcfg)))


def _listen(rec, source, **kw):
    with source as s:
        return rec.listen(s, **kw)


def test_listen_captures_the_phrase_as_jax_does():
    wave = np.concatenate([silence(0.5), speech(1.5), silence(1.2)])
    trec, jrec = recognizers()
    audio = _listen(trec, fake_source(wave))
    assert isinstance(audio, AudioData)
    assert audio.frame_data == _listen(jrec, jax_source(wave)).frame_data
    n = len(audio.get_array_data())
    assert 1.5 * RATE <= n <= (0.35 + 1.5 + 0.8 + 0.2) * RATE
    assert rms(audio.frame_data, 2) > 1000 * 0.5
    # deterministic: the same source captures the same bytes
    assert _listen(trec, fake_source(wave)).frame_data == audio.frame_data


def test_listen_times_out_on_silence():
    trec, _ = recognizers()
    with pytest.raises(WaitTimeoutError):
        _listen(trec, fake_source(silence(3.0)), timeout=0.5)


def test_listen_phrase_time_limit():
    wave = np.concatenate([speech(3.0), silence(1.2)])
    trec, jrec = recognizers()
    audio = _listen(trec, fake_source(wave), phrase_time_limit=1.0)
    assert len(audio.get_array_data()) <= 1.6 * RATE
    assert audio.frame_data == _listen(jrec, jax_source(wave),
                                       phrase_time_limit=1.0).frame_data


def test_dynamic_energy_threshold_decays_during_silence():
    wave = np.concatenate([silence(1.0), speech(1.0), silence(1.2)])
    trec, jrec = recognizers()
    trec.dynamic_energy_threshold = jrec.dynamic_energy_threshold = True
    _listen(trec, fake_source(wave))
    _listen(jrec, jax_source(wave))
    assert trec.energy_threshold < 1000
    assert trec.energy_threshold == pytest.approx(jrec.energy_threshold, rel=1e-12)


def test_listen_needs_an_entered_source():
    trec, _ = recognizers()
    with pytest.raises(AssertionError):
        trec.listen(fake_source(silence(0.1)))


def test_streaming_transcribes_each_phrase_as_jax_does(models):
    """Two spoken phrases: two transcripts, each equal to recognize() on the
    phrase's samples, and to the JAX recognizer's streaming."""
    wave = np.concatenate([silence(0.4), speech(0.4, seed=1), silence(1.2),
                           speech(1.5, seed=2), silence(1.2)])
    outs = {}
    for name, rec, src in (("torch", recognizers(models)[0],
                            fake_source(wave, idle_at_end=True)),
                           ("jax", recognizers(models)[1],
                            jax_source(wave, idle_at_end=True))):
        rec.enable_streaming()
        assert rec.stream is True
        gen = rec.streaming(src)
        outs[name] = [next(gen), next(gen)]
        rec.disable_streaming()
        assert rec.stream is False
        rec.stream_thread_stopper(wait_for_stop=True)
    assert outs["torch"] == outs["jax"]
    assert all(isinstance(t, str) and t for t in outs["torch"])


def test_streaming_transcript_is_recognize_of_the_phrase(models):
    """The phrase the background listener assembles is what recognize()
    reads: one phrase, its samples gathered here from listen_stream."""
    wave = np.concatenate([silence(0.3), speech(1.2, seed=5), silence(1.2)])
    trec, _ = recognizers(models)
    trec.stream = True
    parts = []
    with fake_source(wave) as s:
        for is_last, data in trec.listen_stream(s):
            parts.append(TRecognizer.get_audio_data(
                data if isinstance(data, list) else [data], s))
            if is_last:
                break
    phrase = np.concatenate(parts)
    trec.stream = False
    trec.enable_streaming()
    gen = trec.streaming(fake_source(wave, idle_at_end=True))
    assert next(gen) == trec.recognize(phrase)
    trec.disable_streaming()
    trec.stream_thread_stopper(wait_for_stop=True)


def test_disable_streaming_pins_the_toggle():
    """As in the JAX package (C17): disable_streaming on a recognizer that
    is not streaming enables streaming; enable_streaming twice keeps it on.
    A stream whose listener never started stops without a stopper (the JAX
    recognizer calls None and raises TypeError)."""
    trec, jrec = recognizers()
    for rec in (trec, jrec):
        assert rec.stream is False
        rec.disable_streaming()
        assert rec.stream is True
        rec.enable_streaming()
        assert rec.stream is True
    trec.disable_streaming()
    assert trec.stream is False
    with pytest.raises(TypeError):
        jrec.disable_streaming()


def test_adjust_for_speech_sets_threshold_from_average():
    wave = speech(4.5, seed=3)
    trec, jrec = recognizers()
    for rec, src in ((trec, fake_source(wave)), (jrec, jax_source(wave))):
        with src as s:
            rec.adjust_for_speech(s, duration=4)
    spb = CHUNK / RATE
    pcm = (np.clip(wave, -1, 1) * 32767).astype("<i2").tobytes()
    energies, elapsed, pos = [], 0.0, 0
    while True:
        elapsed += spb
        if elapsed > 4:
            break
        energies.append(rms(pcm[pos:pos + CHUNK * 2], 2))
        pos += CHUNK * 2
    assert trec.energy_threshold == pytest.approx(sum(energies) / len(energies) - 80)
    assert trec.energy_threshold == jrec.energy_threshold
    # a quiet room keeps the average itself (no 80 subtracted)
    with fake_source(speech(1.0, seed=4, amp=0.001)) as s:
        trec.adjust_for_speech(s, duration=0.5)
    assert 0 < trec.energy_threshold <= 80


def test_adjust_for_ambient_noise_decays_on_silence():
    trec, jrec = recognizers()
    for rec, src in ((trec, fake_source(silence(2.5))), (jrec, jax_source(silence(2.5)))):
        with src as s:
            rec.adjust_for_ambient_noise(s, duration=2)
    spb = CHUNK / RATE
    damping = trec.dynamic_energy_adjustment_damping ** spb
    assert trec.energy_threshold == pytest.approx(1000 * damping ** int(2 / spb))
    assert trec.energy_threshold == jrec.energy_threshold


def test_update_stream_parameters():
    trec, _ = recognizers()
    trec.update_stream_parameters(energy_threshold=123, pause_threshold=1.5,
                                  phrase_threshold=0.5, non_speaing_duration=0.4)
    assert (trec.energy_threshold, trec.pause_threshold, trec.phrase_threshold,
            trec.non_speaking_duration) == (123, 1.5, 0.5, 0.4)
    trec.update_stream_parameters()  # None keeps every value
    assert trec.energy_threshold == 123 and trec.non_speaking_duration == 0.4


def test_recognize_long_form_names_its_slice(models):
    """recognize_long_form with no mesh makes one (here a group of this
    process alone on the CPU), keeps it for later calls, and transcribes as
    recognize, and as the JAX package's over its CPU mesh."""
    import torch.distributed as dist

    trec, jrec = recognizers(models)
    audio = speech(3.0, seed=4)
    try:
        assert trec.recognize_long_form(audio) == trec.recognize(audio)
        mesh = trec.danspeech_recognizer.long_form_mesh
        assert mesh is not None and mesh.world_size == 1
        assert trec.recognize_long_form(audio) == jrec.recognize_long_form(audio)
        assert trec.danspeech_recognizer.long_form_mesh is mesh
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
