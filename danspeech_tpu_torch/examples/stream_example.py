"""Silence-segmented streaming, one transcript per phrase: the twin of
``examples/stream_example.py``.

Opens the microphone (PyAudio), calibrates the energy VAD, then yields one
transcription per detected phrase from ``Recognizer.streaming``. ``--wav``
reads a file as the source instead (a quiet device once it is read);
``--phrases N`` stops after N transcripts, where the JAX script runs until
Ctrl-C. The JAX script never calls ``enable_streaming``, so its generator
ends before its first phrase; the twin enables streaming first.

Run:  python -m danspeech_tpu_torch.examples.stream_example --wav PATH --phrases 2
      [--random-weights | --pth MODEL.pth] [--device cpu]
"""

from __future__ import annotations

import argparse

from . import add_device, add_pth, add_random_weights, file_source, parse, pick_model

# TestModel's shape: 2 conv, 5x400 bidirectional GRU
TEST_MODEL = dict(model_name="TestModel-random", rnn_hidden_size=400, rnn_layers=5,
                  conv_layers=2)


def stream(recognizer, source, phrases: int | None = None) -> list[str]:
    """Transcribe ``source`` phrase by phrase until ``phrases`` transcripts
    (None: until interrupted); prints and returns them. Stops the listener
    before it returns."""
    texts = []
    recognizer.enable_streaming()
    print("Speak! (Ctrl-C to stop)")
    try:
        for transcription in recognizer.streaming(source):
            print("Transcription:", transcription)
            texts.append(transcription)
            if phrases is not None and len(texts) >= phrases:
                break
    except KeyboardInterrupt:
        print("Stopped.")
    finally:
        if recognizer.stream:
            recognizer.disable_streaming()
        if recognizer.stream_thread_stopper is not None:
            recognizer.stream_thread_stopper(wait_for_stop=True)
    return texts


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wav", help="simulate the mic from a wav file")
    ap.add_argument("--phrases", type=int, default=None,
                    help="stop after this many transcripts (default: until Ctrl-C)")
    add_random_weights(ap)
    add_pth(ap)
    add_device(ap)
    args = parse(ap, argv)

    from .. import Recognizer, pretrained_models
    from ..audio import Microphone
    from ..models import DeepSpeechConfig

    model = pick_model(args.pth, args.random_weights, DeepSpeechConfig(**TEST_MODEL), 0,
                       pretrained_models.TestModel)
    recognizer = Recognizer(model=model, device=args.device)
    if args.wav:
        source = file_source(args.wav)
    else:
        source = Microphone(sampling_rate=16000)
        with source:
            print("Calibrating ambient noise threshold...")
            recognizer.adjust_for_ambient_noise(source, duration=2)
    return stream(recognizer, source, args.phrases)


if __name__ == "__main__":
    main()
