"""Real-time chunked streaming with a unidirectional lookahead model: the
twin of ``examples/real_time_streaming_example.py``.

Partial transcripts print as the audio arrives (the conv caches and GRU
states stay on the device between chunks; ``gru_scan`` at B = 1 on CUDA);
when the utterance ends, a secondary bidirectional model re-transcribes the
whole stream for the final transcript. The models are the zoo's
CPUStreamingRNN and TestModel (downloaded), their shapes with seeded
weights (``--random-weights``) or packages (``--pth``, ``--secondary-pth``).
``--wav`` reads a file at a microphone's pace as the source (read at disk
speed it would hand over the whole phrase in one pass, ROADMAP C7);
``--phrases N`` stops after N finals, where the JAX script runs until
Ctrl-C.

Run:  python -m danspeech_tpu_torch.examples.real_time_streaming_example --wav PATH
      --phrases 1 [--random-weights | --pth M.pth --secondary-pth S.pth] [--device cpu]
"""

from __future__ import annotations

import argparse

from . import add_device, add_pth, add_random_weights, file_source, parse, pick_model

# the zoo shapes: CPUStreamingRNN (2 conv, 5x800 unidirectional GRU,
# lookahead 20) and TestModel (2 conv, 5x400 bidirectional GRU)
CPU_STREAMING = dict(model_name="CPUStreamingRNN-random", rnn_hidden_size=800,
                     rnn_layers=5, conv_layers=2, bidirectional=False, context=20,
                     streaming_model=True)
TEST_MODEL = dict(model_name="TestModel-random", rnn_hidden_size=400, rnn_layers=5,
                  conv_layers=2)


def stream(recognizer, source, model, secondary, phrases: int | None = None) -> list:
    """Stream ``source`` until ``phrases`` finals (None: until interrupted);
    prints and returns every (is_last, transcript) the generator yields.
    Stops the listener before it returns."""
    recognizer.enable_real_time_streaming(
        streaming_model=model, string_parts=False, secondary_model=secondary)
    print("Speak! Partial transcriptions appear as you go. (Ctrl-C stops)")
    events, finals = [], 0
    generator = recognizer.real_time_streaming(source)
    try:
        for is_last, transcription in generator:
            events.append((is_last, transcription))
            if is_last:
                print("\nFinal:", transcription)
                finals += 1
                if phrases is not None and finals >= phrases:
                    break
                continue
            print("\r" + transcription, end="", flush=True)
    except KeyboardInterrupt:
        print("\nStopped.")
    finally:
        generator.close()
        recognizer.disable_real_time_streaming(keep_secondary_model_loaded=True)
        if recognizer.stream_thread_stopper is not None:
            recognizer.stream_thread_stopper(wait_for_stop=True)
    return events


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wav", help="simulate the mic from a wav file")
    ap.add_argument("--phrases", type=int, default=None,
                    help="stop after this many finals (default: until Ctrl-C)")
    add_random_weights(ap)
    add_pth(ap, role="streaming model")
    add_pth(ap, "--secondary-pth", role="secondary model")
    add_device(ap)
    args = parse(ap, argv)

    from .. import Recognizer, pretrained_models
    from ..audio import Microphone
    from ..models import DeepSpeechConfig

    model = pick_model(args.pth, args.random_weights, DeepSpeechConfig(**CPU_STREAMING), 0,
                       pretrained_models.CPUStreamingRNN)
    secondary = pick_model(args.secondary_pth, args.random_weights,
                           DeepSpeechConfig(**TEST_MODEL), 1, pretrained_models.TestModel)
    recognizer = Recognizer(model=model, device=args.device)
    if args.wav:
        source = file_source(args.wav, paced=True)
    else:
        source = Microphone(sampling_rate=16000)
        with source:
            recognizer.adjust_for_ambient_noise(source, duration=2)
    return stream(recognizer, source, model, secondary, args.phrases)


if __name__ == "__main__":
    main()
