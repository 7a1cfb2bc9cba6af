"""High-throughput batch serving with the int16 fast path: the twin of
``examples/batch_serving.py``.

``Recognizer.recognize_batch`` runs the bucketed scheduler: length-bucketed
dispatch groups of up to 128 rows, pinned int16 staging buffers, the
argmax on the device and the host collapse of the paths. The first call
warms up (kernel builds on CUDA); the second is timed.

Run:  python -m danspeech_tpu_torch.examples.batch_serving --wav-dir DIR
      [--pth MODEL.pth] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

from . import add_device, add_pth, parse, wav_paths

# the JAX script's demo model (random weights): 2 conv, 5x400 bidirectional GRU
DEMO = dict(model_name="demo", rnn_hidden_size=400, rnn_layers=5, conv_layers=2)


def serve(recognizer, paths: list[str]) -> dict:
    """Load ``paths`` as int16 and transcribe them twice (warm-up, timed);
    prints and returns the clips' count and audio seconds, each clip's
    transcript, the timed call's wall time and audio-s/s."""
    from ..audio import load_audio_pcm16

    # int16 loader: half the host->device bytes of the float path; the
    # engine stages int16 as it is and casts on the device
    waves = [load_audio_pcm16(p) for p in paths]
    audio_s = sum(len(w) for w in waves) / 16000
    print(f"{len(waves)} clips, {audio_s:.1f} s audio")

    recognizer.recognize_batch(waves)  # warm-up
    t0 = time.perf_counter()
    texts = recognizer.recognize_batch(waves)
    wall = time.perf_counter() - t0
    rate = audio_s / wall
    for path, text in zip(paths, texts):
        print(f"  {os.path.basename(path)}: {text[:60]}")
    print(f"batch decode: {wall * 1e3:.0f} ms -> {rate:,.0f} audio-s/s")
    return {"clips": len(waves), "audio_s": audio_s, "texts": texts, "wall_s": wall,
            "audio_s_per_s": rate}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wav-dir", default=None, help="directory of 16 kHz PCM wavs")
    add_pth(ap)
    add_device(ap)
    args = parse(ap, argv)
    paths = wav_paths(ap, args.wav_dir)

    from .. import Recognizer
    from ..models import DeepSpeechConfig, DeepSpeechModel
    from ..pretrained_models import CustomModel

    model = (CustomModel(args.pth) if args.pth
             else DeepSpeechModel.init_random(DeepSpeechConfig(**DEMO), seed=0))
    return serve(Recognizer(model=model, device=args.device), paths)


if __name__ == "__main__":
    main()
