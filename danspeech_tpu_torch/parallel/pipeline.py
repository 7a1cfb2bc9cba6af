"""Pipeline-parallel inference: layer stages on devices, microbatched.

The port of ``danspeech_tpu/parallel/pipeline.py``. The network is split
into ``n_stages`` contiguous stages: stage 0 carries the spectrogram, the
conv stack and its share of the RNN layers, middle stages carry RNN layers,
the last stage adds the lookahead (unidirectional models), the BN -> Linear
head and the softmax. Each stage's parameter slice is cast and placed on its
device once, at construction. A batch is cut into microbatches of
``micro_batch`` rows; the final one is padded to the full count with its
lengths pinned to a real row, and the pad rows are sliced off.

The JAX package overlaps the stages through its per-device dispatch queues.
Here each CUDA device runs its stages on a stream of its own: microbatch
k's stage s is enqueued on its device's stream after an event that stage
s - 1 recorded when it produced k's activations, which cross with
``.to(device, non_blocking=True)``; nothing waits on the host until the
results are read. ``devices`` may name one device several times, which is
how one card, or the CPU, runs several stages; stages that share a device
run in order on it.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from ..features.spectrogram import SpectrogramAudioParser
from ..models import deepspeech as ds
from ..ops import conv as conv_ops
from ..ops import stft as stft_ops
from .batch import bucket_maxlen


def partition_layers(n_rnn: int, n_stages: int) -> list[range]:
    """Split rnn layer indices into n_stages contiguous, near-even groups.

    The conv stack rides with stage 0 and the head with the last stage,
    so when layers don't divide evenly the extra layers go to the MIDDLE
    stages first (stage 0 and the last stage are already the heaviest).
    """
    if not 1 <= n_stages <= n_rnn:
        raise ValueError(f"n_stages={n_stages} must be in [1, {n_rnn}]")
    base, extra = divmod(n_rnn, n_stages)
    sizes = [base] * n_stages
    order = sorted(range(n_stages), key=lambda s: (s in (0, n_stages - 1), s))
    for i in range(extra):
        sizes[order[i]] += 1
    bounds = np.cumsum([0] + sizes)
    return [range(int(bounds[s]), int(bounds[s + 1])) for s in range(n_stages)]


def _default_devices() -> list[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices=['cpu', ...] to run on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class PipelinedTranscriber:
    """GPipe-style microbatched inference over per-device layer stages."""

    SAMPLE_BUCKET = 16000

    def __init__(self, model, devices=None, n_stages: int | None = None,
                 micro_batch: int = 8):
        self.model = model
        self.config = config = model.config
        devices = [torch.device(d) for d in devices] if devices is not None \
            else _default_devices()
        n_rnn = config.rnn_layers
        if n_stages is None:
            n_stages = min(len(devices), n_rnn)
        if n_stages > len(devices):
            raise ValueError(f"n_stages={n_stages} exceeds {len(devices)} devices")
        self.devices = devices[:n_stages]
        self.n_stages = n_stages
        self.micro_batch = int(micro_batch)
        self.stage_layers = partition_layers(n_rnn, n_stages)
        self._parser = SpectrogramAudioParser(model.audio_conf)

        params = model.params
        cast = (ds.cast_matmul_weights(params, torch.bfloat16)
                if any(d.type == "cuda" for d in self.devices) else None)
        self._stage_params = []
        for s, layers in enumerate(self.stage_layers):
            # bf16 matmul weights on CUDA (the recurrent kernels' dtype)
            src = cast if self.devices[s].type == "cuda" else params
            piece = {"rnns": [src["rnns"][i] for i in layers]}
            if s == 0:
                piece["conv"] = src["conv"]
            if s == n_stages - 1:
                piece["fc_bn"] = src["fc_bn"]
                piece["fc"] = src["fc"]
                if not config.bidirectional:
                    piece["lookahead"] = src["lookahead"]
            self._stage_params.append(ds.params_to(piece, self.devices[s]))
        self._window = self._parser.window.to(self.devices[0])
        # one stream a CUDA device: stages that share a card run in order on
        # it (each persistent kernel fills the card anyway)
        per_device = {d: torch.cuda.Stream(d) for d in set(self.devices)
                      if d.type == "cuda"}
        self._streams = [per_device.get(d) for d in self.devices]

    def _run_stage(self, s: int, x, lengths):
        config, piece = self.config, self._stage_params[s]
        if s == 0:
            parser = self._parser
            spect, frame_lens = stft_ops.batched_log_spectrogram(
                x, lengths, parser.n_fft, parser.hop_length, self._window,
                normalize=parser.normalize,
            )
            lengths = ds.get_seq_lens(config, frame_lens)
            h = ds.conv_stack(piece, config, spect[:, None], lengths)
            n, c, f, t = h.shape
            x = h.reshape(n, c * f, t).permute(2, 0, 1)
        for entry in piece["rnns"]:
            x = ds._apply_rnn_layer(config.rnn_type, entry, x, lengths, "auto")
        if s == self.n_stages - 1:
            if not config.bidirectional:
                x = conv_ops.hardtanh(conv_ops.lookahead(x, piece["lookahead"]))
            x = torch.softmax(ds.head(piece, x).permute(1, 0, 2), dim=-1)
        return x, lengths

    @torch.inference_mode()
    def acoustic_probs(self, recordings: list[np.ndarray]):
        """Waveforms -> (probs (B, T, C), out_lengths) numpy, microbatch-
        pipelined: microbatch k's stage s is enqueued right after its
        stage s - 1, so the stages work on different microbatches at once."""
        b = len(recordings)
        if b == 0:
            return (np.zeros((0, 0, len(self.model.labels)), np.float32),
                    np.zeros((0,), np.int32))
        lengths = np.array([len(r) for r in recordings], dtype=np.int32)
        maxlen = bucket_maxlen(lengths, self.SAMPLE_BUCKET)
        mb = self.micro_batch
        outs = []
        for k in range(0, b, mb):
            rows = recordings[k : k + mb]
            # pad the final microbatch to mb rows (pad lengths pinned to a
            # real row): every stage sees one shape
            batch = np.zeros((mb, maxlen), dtype=np.float32)
            ln_np = np.empty((mb,), np.int32)
            for j, r in enumerate(rows):
                batch[j, : len(r)] = r
                ln_np[j] = len(r)
            ln_np[len(rows):] = ln_np[0]
            x, ln = torch.from_numpy(batch), torch.from_numpy(ln_np)
            ready = None
            for s, dev in enumerate(self.devices):
                stream = self._streams[s]
                with torch.cuda.stream(stream) if stream is not None else nullcontext():
                    if stream is not None and ready is not None:
                        stream.wait_event(ready)
                    x = x.to(dev, non_blocking=True)
                    ln = ln.to(dev, non_blocking=True)
                    x, ln = self._run_stage(s, x, ln)
                    if stream is not None:
                        # the next stage's stream reads these: keep their
                        # memory from being reused before it has
                        ready = torch.cuda.Event()
                        ready.record(stream)
                        nxt = self._streams[s + 1] if s + 1 < self.n_stages else None
                        if nxt is not None:
                            x.record_stream(nxt)
                            ln.record_stream(nxt)
            outs.append((x, ln, len(rows), ready))
        probs, out_lens = [], []
        for x, ln, n, ready in outs:
            if ready is not None:
                ready.synchronize()
            probs.append(x[:n].float().cpu().numpy())
            out_lens.append(ln[:n].cpu().numpy())
        return np.concatenate(probs, axis=0), np.concatenate(out_lens, axis=0)

    def transcribe(self, recordings: list[np.ndarray], decoder) -> list[str]:
        probs, out_lens = self.acoustic_probs(recordings)
        decoded, _ = decoder.decode(probs, out_lens)
        return [d[0] for d in decoded]
