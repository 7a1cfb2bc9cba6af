"""The LM beam on the host, on the device and sharded over a mesh, and a
long recording's time axis sharded over the mesh: the twin of
``examples/device_beam_and_long_form.py``.

The same ``Recognizer`` reaches

- ``backend="host"``: the C++ beam with the LM fused (``decode/beam.py``);
- ``backend="device"``: the beam search and the LM fusion on the device
  (the n-gram tables as hash tables there, ``decode/device_lm.py``);
- ``backend="sharded"``: the beam front sharded over the ranks of a mesh
  (``decode/dist_beam.py``);
- ``recognize_long_form``: one utterance's time axis sharded over the mesh
  (``parallel/time_shard.py``).

Without a launcher the mesh is this process alone (``parallel.make_mesh``);
the twin destroys the process group it made.

Run:  python -m danspeech_tpu_torch.examples.device_beam_and_long_form --wav PATH
      [--pth MODEL.pth] [--arpa LM.arpa] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from . import add_arpa, add_device, add_pth, parse, require_wav

# the JAX script's demo model (random weights): 2 conv, 2x96 bidirectional GRU
DEMO = dict(model_name="demo", rnn_hidden_size=96, rnn_layers=2, conv_layers=2)


def demo_lm():
    """A tiny seeded bigram LM (the JAX script's stand-in for the zoo's DSL
    3-gram): the same n-grams and values as its ``demo_lm``."""
    from ..decode.lm import NgramLM

    rng = np.random.default_rng(0)
    words = ["hej", "med", "dig", "tak", "og", "det", "er", "nu"]
    lm = NgramLM(2)
    for w in words:
        lm.add_ngram((w,), float(rng.uniform(-2, -0.3)), float(rng.uniform(-0.5, 0)))
    for _ in range(20):
        pair = tuple(words[i] for i in rng.integers(0, len(words), 2))
        if pair not in lm.tables[1]:
            lm.add_ngram(pair, float(rng.uniform(-1.5, -0.1)))
    return lm


def decode_all(model, waveform, lm, device, mesh) -> dict:
    """The host, device and sharded beams of ``waveform`` (alpha 1.0, beta
    0.3, beam 16), then greedy ``recognize_long_form`` of it four times over
    on ``mesh``; prints and returns each transcript."""
    from .. import Recognizer

    recognizer = Recognizer(model=model, lm=lm, alpha=1.0, beta=0.3, device=device)
    recognizer.update_decoder(beam_width=16)
    out = {"host": recognizer.recognize(waveform)}
    print("host C++ beam:    ", out["host"])

    recognizer.update_decoder(backend="device")
    out["device"] = recognizer.recognize(waveform)
    print("on-device LM beam:", out["device"])

    recognizer.update_decoder(backend="sharded", mesh=mesh)
    out["sharded"] = recognizer.recognize(waveform)
    print("mesh-sharded beam:", out["sharded"])

    # long form: the time axis sharded over the mesh (greedy decode)
    long_audio = np.concatenate([waveform] * 4)
    greedy = Recognizer(model=model, device=device)
    out["long_form"] = greedy.recognize_long_form(long_audio, mesh=mesh)
    print("long-form (greedy):", out["long_form"][:80])
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wav", default=None, help="the utterance to transcribe")
    add_pth(ap)
    add_arpa(ap)
    add_device(ap)
    args = parse(ap, argv)
    wav = require_wav(ap, args.wav)

    import torch.distributed as dist

    from ..audio import load_audio
    from ..models import DeepSpeechConfig, DeepSpeechModel
    from ..parallel.mesh import make_mesh
    from ..pretrained_models import CustomModel

    model = (CustomModel(args.pth) if args.pth
             else DeepSpeechModel.init_random(DeepSpeechConfig(**DEMO), seed=3))
    made_group = not dist.is_initialized()
    mesh = make_mesh(device=args.device)
    try:
        return decode_all(model, load_audio(wav), args.arpa or demo_lm(), args.device,
                          mesh)
    finally:
        if made_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
