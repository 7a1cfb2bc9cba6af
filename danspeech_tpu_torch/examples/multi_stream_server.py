"""Cohort-batched multi-stream serving: the twin of
``examples/multi_stream_server.py``.

S live sessions are stepped together through one chunk step whose batch is
the stream index (``MultiStreamTranscriber``: the unidirectional GRU's
``gru_scan`` kernel at B = S on CUDA). The sessions are simulated from the
WAVs of ``--wav-dir``, concatenated; each prints its rolling transcript.

Run:  python -m danspeech_tpu_torch.examples.multi_stream_server --wav-dir DIR
      [--streams 8] [--chunk-ms 1000] [--pth MODEL.pth] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from . import add_device, add_pth, parse, wav_paths

# CPUStreamingRNN's shape (the JAX script's demo, random weights): 2 conv,
# 5x800 unidirectional GRU, lookahead context 20
DEMO = dict(model_name="CPUStreamingRNN", rnn_hidden_size=800, rnn_layers=5,
            conv_layers=2, bidirectional=False, context=20, streaming_model=True)
N_CHUNKS = 5


def demo_stream_model():
    """CPUStreamingRNN-shaped model with weights from seed 0, its matmul
    weights in bf16, as the JAX script builds it."""
    from ..models import DeepSpeechConfig, DeepSpeechModel
    from ..models import deepspeech as ds

    cfg = DeepSpeechConfig(**DEMO)
    return DeepSpeechModel(cfg, ds.cast_matmul_weights(ds.init_params(cfg, seed=0)))


def session_streams(waves, n_streams: int, chunk: int) -> list[np.ndarray]:
    """Stream s: N_CHUNKS chunks of the concatenated WAVs from second s on
    (wrapping), as the JAX script cuts them."""
    buf = np.concatenate(waves)
    if len(buf) <= N_CHUNKS * chunk:
        raise ValueError(f"{len(buf)} samples of audio: the sessions need more than "
                         f"{N_CHUNKS * chunk}")
    return [buf[(s * 16000) % (len(buf) - N_CHUNKS * chunk):][: N_CHUNKS * chunk]
            for s in range(n_streams)]


def serve_streams(ms, streams, chunk: int) -> list[list[str]]:
    """Step the cohort chunk by chunk; prints and returns every stream's
    transcript after each chunk (the last step's are the finals)."""
    steps = []
    for ci in range(N_CHUNKS):
        cohort = [st[ci * chunk : (ci + 1) * chunk] for st in streams]
        outs = ms.step(cohort, is_first=(ci == 0), is_last=(ci == N_CHUNKS - 1))
        print(f"--- chunk {ci + 1}/{N_CHUNKS} ---")
        for s, text in enumerate(outs):
            tag = "final" if ci == N_CHUNKS - 1 else "part"
            print(f"  stream {s:2d} [{tag}]: {text!r}")
        steps.append(list(outs))
    return steps


def main(argv=None) -> list[list[str]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--chunk-ms", type=int, default=1000)
    ap.add_argument("--wav-dir", default=None,
                    help="directory of 16 kHz PCM wavs the sessions are cut from")
    add_pth(ap)
    add_device(ap)
    args = parse(ap, argv)
    paths = wav_paths(ap, args.wav_dir)

    from .. import MultiStreamTranscriber
    from ..audio import load_audio_wavPCM
    from ..pretrained_models import CustomModel

    chunk = 16 * args.chunk_ms  # samples at 16 kHz
    streams = session_streams([load_audio_wavPCM(p) for p in paths], args.streams, chunk)
    model = CustomModel(args.pth) if args.pth else demo_stream_model()
    ms = MultiStreamTranscriber(model, n_streams=args.streams, device=args.device)
    return serve_streams(ms, streams, chunk)


if __name__ == "__main__":
    main()
