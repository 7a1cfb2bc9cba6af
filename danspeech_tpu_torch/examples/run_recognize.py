"""One-shot file transcription, greedy then LM beam then every beam: the
twin of ``examples/run_recognize.py``.

Transcribes one utterance greedily, then (when a language model is at hand)
with the LM-fused beam search, and shows every surviving beam. The model
is the zoo's TestModel (downloaded), its shape with seeded weights
(``--random-weights``) or a package (``--pth``); the LM the zoo's DSL 3-gram
or ``--arpa``. With the model given offline and no ``--arpa``, the 3-gram
is looked up in the cache only, and the beam decoding is skipped, with a
note, when it is not there.

Run:  python -m danspeech_tpu_torch.examples.run_recognize --wav PATH
      [--random-weights | --pth MODEL.pth] [--arpa LM.arpa] [--device cpu]
"""

from __future__ import annotations

import argparse

from . import (add_arpa, add_device, add_pth, add_random_weights, parse, pick_lm,
               pick_model, require_wav)

# TestModel's shape: 2 conv, 5x400 bidirectional GRU
TEST_MODEL = dict(model_name="TestModel-random", rnn_hidden_size=400, rnn_layers=5,
                  conv_layers=2)


def recognize(recognizer, audio, lm, skipped=None) -> dict:
    """Greedy, then (with ``lm``) the beam's best and every beam; prints and
    returns them."""
    print("Greedy transcription:")
    greedy = recognizer.recognize(audio)
    print(" ", greedy)
    out = {"greedy": greedy, "beam": None, "all_beams": None, "lm_skipped": skipped}
    if lm is None:
        print(f"(beam decoding skipped: {skipped})")
        return out
    recognizer.update_decoder(lm=lm)
    print("LM beam-search transcription:")
    out["beam"] = recognizer.recognize(audio, show_all=False)
    print(" ", out["beam"])
    print("All beams:")
    out["all_beams"] = recognizer.recognize(audio, show_all=True)
    for beam in out["all_beams"]:
        print(" ", beam)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wav", default=None, help="the utterance to transcribe")
    add_random_weights(ap)
    add_pth(ap)
    add_arpa(ap)
    add_device(ap)
    args = parse(ap, argv)
    wav = require_wav(ap, args.wav)

    from .. import Recognizer, language_models, pretrained_models
    from ..audio import load_audio
    from ..models import DeepSpeechConfig

    model = pick_model(args.pth, args.random_weights, DeepSpeechConfig(**TEST_MODEL), 0,
                       pretrained_models.TestModel)
    lm, skipped = pick_lm(args.arpa, bool(args.pth or args.random_weights),
                          language_models.DSL3gram)
    recognizer = Recognizer(model=model, device=args.device)
    return recognize(recognizer, load_audio(wav), lm, skipped)


if __name__ == "__main__":
    main()
