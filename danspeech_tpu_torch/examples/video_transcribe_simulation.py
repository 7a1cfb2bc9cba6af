"""Long-form offline transcription with energy-based VAD segmentation: the
twin of ``examples/video_transcribe_simulation.py``.

Walks a long recording in 1024-sample steps, cuts it where the energy
stays low (``audio.dsp.energy_vad_segments``), and transcribes the
segments through ``recognize_batch`` in groups of ``--batch``, so that the
device sees batches instead of one utterance at a time. The model is the
zoo's Folketinget with its 3-gram LM and tuned beam (downloaded), TestModel
with ``--test-model``, their shapes with seeded weights
(``--random-weights``) or a package (``--pth``); ``--arpa`` replaces the LM.
With the model given offline and no ``--arpa``, the 3-gram is looked up in
the cache only and the twin decodes greedily, with a note, when it is not
there.

Run:  python -m danspeech_tpu_torch.examples.video_transcribe_simulation AUDIO
      [--random-weights | --pth MODEL.pth] [--arpa LM.arpa] [--device cpu]
"""

from __future__ import annotations

import argparse

from . import (add_arpa, add_device, add_pth, add_random_weights, parse, pick_lm,
               pick_model, require_wav)

STEP = 1024
# the zoo shapes: Folketinget (3 conv, 9x1200 bidirectional GRU) and
# TestModel (2 conv, 5x400 bidirectional GRU)
FOLKETINGET = dict(model_name="Folketinget-random", rnn_hidden_size=1200, rnn_layers=9,
                   conv_layers=3)
TEST_MODEL = dict(model_name="TestModel-random", rnn_hidden_size=400, rnn_layers=5,
                  conv_layers=2)
# the original script's tuned long-form decoder
ALPHA, BETA, BEAM = 1.0471119809697471, 2.8309374387487924, 64


def transcribe(recognizer, audio, energy_threshold: float, batch: int) -> dict:
    """Segment ``audio`` (int16 sample scale) and transcribe the segments
    ``batch`` at a time; prints and returns the (start, end) ranges and
    each segment's transcript."""
    from ..audio.dsp import energy_vad_segments

    ranges = energy_vad_segments(audio, step=STEP, energy_threshold=energy_threshold,
                                 max_pause_steps=12, min_segment_samples=16000)
    segments = []
    for i in range(0, len(ranges), batch):
        pending = [audio[a:b] for a, b in ranges[i : i + batch]]
        segments.extend(recognizer.recognize_batch(pending))
    for i, text in enumerate(segments):
        print(f"[{i:4d}] {text}")
    return {"ranges": ranges, "segments": segments}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("audio", help="path to the long recording")
    ap.add_argument("--offset-seconds", type=float, default=0.0)
    ap.add_argument("--energy-threshold", type=float, default=700.0)
    ap.add_argument("--test-model", action="store_true",
                    help="use the small TestModel instead of Folketinget")
    ap.add_argument("--batch", type=int, default=16,
                    help="utterance segments per device batch")
    add_random_weights(ap)
    add_pth(ap)
    add_arpa(ap)
    add_device(ap)
    args = parse(ap, argv)
    path = require_wav(ap, args.audio, "the AUDIO argument")

    from .. import Recognizer, language_models, pretrained_models
    from ..audio import load_audio
    from ..models import DeepSpeechConfig

    offline = bool(args.pth or args.random_weights)
    if args.test_model:
        model = pick_model(args.pth, args.random_weights, DeepSpeechConfig(**TEST_MODEL),
                           0, pretrained_models.TestModel)
        recognizer = Recognizer(model=model, device=args.device)
    else:
        model = pick_model(args.pth, args.random_weights, DeepSpeechConfig(**FOLKETINGET),
                           0, pretrained_models.Folketinget)
        lm, skipped = pick_lm(args.arpa, offline, language_models.Folketinget3gram)
        if lm is None:
            print(f"(LM beam skipped, greedy decoding: {skipped})")
            recognizer = Recognizer(model=model, device=args.device)
        else:
            recognizer = Recognizer(model=model, lm=lm, alpha=ALPHA, beta=BETA,
                                    beam_width=BEAM, device=args.device)

    audio = load_audio(path)
    audio = audio[int(args.offset_seconds * 16000):]
    return transcribe(recognizer, audio, args.energy_threshold, args.batch)


if __name__ == "__main__":
    main()
