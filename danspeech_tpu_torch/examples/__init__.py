"""The gallery: twins of the JAX package's ``examples/*.py`` on the port.

Each module has the name, arguments and defaults of its JAX script, a
``main(argv=None)`` that tests and ``chip_smoke.py`` call in-process, and
runs as ``python -m danspeech_tpu_torch.examples.<name>``. ``main`` prints
from a function that returns what it printed. Every twin takes
``--device`` (default CUDA, raising without a GPU; ``cpu`` runs on the
CPU). Where the JAX script builds its own model, the twin also takes
``--pth PATH`` (a ``.pth`` or ``.dsz`` read by
``pretrained_models.CustomModel``); where it downloads a zoo model or LM by
default, the twin keeps that default and adds ``--random-weights`` (the zoo
model's shape, weights from a seed) and, for an LM, ``--arpa PATH``. Given
a model by path or by seed and no ``--arpa``, a twin looks for the zoo LM
in the cache only and says so when it is not there: offline, no twin
touches the network.

Where a JAX script reads the reference checkout's example WAVs by default,
its twin has no default directory and asks for ``--wav`` or ``--wav-dir``.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

from ..audio.io import SpeechFile
from ..device import resolve_device

TWINS = ("batch_serving", "device_beam_and_long_form", "multi_stream_server",
         "real_time_streaming_example", "run_recognize", "stream_example",
         "train_finetune", "video_transcribe_simulation")


def add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: CUDA; 'cpu' runs without a GPU)")


def add_pth(ap: argparse.ArgumentParser, flag: str = "--pth", role: str = "model") -> None:
    ap.add_argument(flag, default=None,
                    help=f"a .pth or .dsz package to use as the {role} instead of the "
                         "script's own")


def add_random_weights(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--random-weights", action="store_true",
                    help="skip the model download: the zoo model's shape with weights "
                         "from a seed (offline)")


def add_arpa(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--arpa", default=None,
                    help="an ARPA (or KenLM) language model to use instead of the zoo's")


def parse(ap: argparse.ArgumentParser, argv):
    """Parse ``argv`` and resolve ``--device`` before anything else runs,
    so that a CUDA default without a GPU raises at once."""
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    return args


def require_wav(ap: argparse.ArgumentParser, path, flag: str = "--wav") -> str:
    if not path or not os.path.isfile(path):
        ap.error(f"no audio file {path!r}: pass {flag} PATH")
    return path


def wav_paths(ap: argparse.ArgumentParser, wav_dir) -> list[str]:
    paths = sorted(glob.glob(os.path.join(wav_dir, "*.wav"))) if wav_dir else []
    if not paths:
        ap.error(f"no .wav files in {wav_dir!r}: pass --wav-dir DIR")
    return paths


def pick_model(path, random_weights: bool, config, seed: int, zoo):
    """The model by path if one is given, else the zoo model's shape with
    weights from ``seed`` if ``random_weights``, else the zoo's download."""
    from ..models import DeepSpeechModel
    from ..pretrained_models import CustomModel

    if path:
        return CustomModel(path)
    if random_weights:
        return DeepSpeechModel.init_random(config, seed=seed)
    return zoo()


def pick_lm(arpa, offline: bool, zoo):
    """(lm, note): ``--arpa`` if given; else the zoo LM, from the cache only
    when ``offline``. A cache miss gives (None, what was skipped)."""
    from ..errors import NotInCacheError
    from ..language_models import CustomLanguageModel

    if arpa:
        return CustomLanguageModel(arpa), None
    try:
        return zoo(download=not offline), None
    except NotInCacheError as e:
        return None, str(e)


def file_source(path: str, paced: bool = False) -> SpeechFile:
    """A SpeechFile read as a capture device is: once the file is read,
    every read waits for its chunk's duration and returns nothing (a quiet
    device), so the background listener does not spin; ``paced`` reads take
    as long as the audio they return, as a live microphone's do (a file
    read at disk speed hands ``real_time_streaming`` the whole phrase in
    one pass, ROADMAP C7)."""

    class CaptureFile(SpeechFile):
        def __enter__(self):
            super().__enter__()
            inner, rate, width = self.stream, self.sampling_rate, self.sampling_width

            class Stream:
                def read(self, size=-1):
                    data = inner.read(size)
                    if not data:
                        time.sleep(max(size, 0) / rate)
                    elif paced:
                        time.sleep(len(data) / width / rate)
                    return data

            self.stream = Stream()
            return self

    return CaptureFile(path)
