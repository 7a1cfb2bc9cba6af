"""Data-parallel batched transcription over a mesh.

The port of ``danspeech_tpu/parallel/batch.py``. Every rank is handed the
same list of waveforms; it pads the batch to a multiple of the data axis and
to a sample-length bucket, runs the spectrogram and the acoustic model on
its own rows (the flagship's layers on ``gru_bidi_fused``, a unidirectional
model's on ``gru_scan``) with no collective inside the forward, and one
``all_gather`` over the data axis returns the whole ``(B, T', C)`` on every
rank. With ``n_model > 1`` each data row's ranks run its rows through the
tensor-parallel forward of :mod:`.tp`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..features.spectrogram import SpectrogramAudioParser
from ..models import deepspeech as ds
from ..ops import stft as stft_ops
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, all_gather


def bucket_maxlen(lengths, quantum: int) -> int:
    """Max sample length padded up to the bucket quantum (shared by the
    mesh and pipeline transcribers so the padding rule cannot diverge)."""
    return max(quantum, -(-int(np.max(lengths)) // quantum) * quantum)


def device_params(params, device: torch.device):
    """A parameter tree as the port serves it on ``device``: bf16 matmul
    weights on CUDA (the recurrent kernels' dtype), float32 elsewhere."""
    if device.type == "cuda":
        params = ds.cast_matmul_weights(params, torch.bfloat16)
    return ds.params_to(params, device)


class ShardedTranscriber:
    """Runs the acoustic model data-parallel across a mesh.

    Pads the utterance batch up to a multiple of the data-axis size and to a
    sample-length bucket, so every rank gets equal rows; padding rows get
    length 1. The parameters are cast and placed on the rank's device once.
    ``shard_model_params`` on a mesh with ``n_model > 1`` runs each rank's
    rows through :func:`.tp.tp_forward` in the mode ``"auto"`` picks
    (``tp_mode``); otherwise every rank
    holds the whole model.
    """

    SAMPLE_BUCKET = 16000

    def __init__(self, model, mesh: Mesh, shard_model_params: bool = True):
        self.model = model
        self.mesh = mesh
        self.n_data = mesh.size(DATA_AXIS)
        self._parser = SpectrogramAudioParser(model.audio_conf)
        self._window = self._parser.window.to(mesh.device)
        self.tp = shard_model_params and mesh.size(MODEL_AXIS) > 1
        self.tp_mode = None
        params = model.params
        if self.tp:
            from .tp import pack_tp_params, resolve_mode

            self.tp_mode = resolve_mode(model.config, mesh.size(MODEL_AXIS), "auto")
            if self.tp_mode == "hidden":
                params = pack_tp_params(params, mesh.size(MODEL_AXIS))
        self.params = device_params(params, mesh.device)

    @torch.inference_mode()
    def _forward(self, waveforms: torch.Tensor, lengths: torch.Tensor):
        parser = self._parser
        spect, frame_lens = stft_ops.batched_log_spectrogram(
            waveforms, lengths, parser.n_fft, parser.hop_length, self._window,
            normalize=parser.normalize,
        )
        if self.tp:
            from .tp import tp_forward

            return tp_forward(self.params, self.model.config, spect[:, None],
                              frame_lens, self.mesh, mode=self.tp_mode)
        return ds.forward(self.params, self.model.config, spect[:, None], frame_lens)

    def local_acoustic_probs(self, recordings: list[np.ndarray]):
        """This rank's rows of the padded batch: (first row index, probs
        (rows, T, C) and out_lengths (rows,) as tensors on the rank's
        device). No collective runs."""
        b = len(recordings)
        b_pad = -(-b // self.n_data) * self.n_data
        lengths = np.ones(b_pad, dtype=np.int32)  # padding rows: length 1
        lengths[:b] = [len(r) for r in recordings]
        maxlen = bucket_maxlen(lengths, self.SAMPLE_BUCKET)
        per = b_pad // self.n_data
        lo = self.mesh.index(DATA_AXIS) * per
        batch = np.zeros((per, maxlen), dtype=np.float32)
        for j, r in enumerate(recordings[lo : lo + per]):
            batch[j, : len(r)] = r
        dev = self.mesh.device
        probs, out_lens = self._forward(torch.from_numpy(batch).to(dev),
                                        torch.from_numpy(lengths[lo : lo + per]).to(dev))
        return lo, probs, out_lens

    def acoustic_probs(self, recordings: list[np.ndarray]):
        """Waveform list -> (probs (B, T, C), out_lengths) numpy, the whole
        batch on every rank, truncated back to the original batch size."""
        b = len(recordings)
        if b == 0:
            return (
                np.zeros((0, 0, len(self.model.labels)), np.float32),
                np.zeros((0,), np.int32),
            )
        _, probs, out_lens = self.local_acoustic_probs(recordings)
        probs = all_gather(probs.float(), self.mesh, DATA_AXIS, dim=0)
        out_lens = all_gather(out_lens.to(torch.int32), self.mesh, DATA_AXIS, dim=0)
        return probs[:b].cpu().numpy(), out_lens[:b].cpu().numpy()

    def transcribe(self, recordings: list[np.ndarray], decoder) -> list[str]:
        probs, out_lens = self.acoustic_probs(recordings)
        decoded, _ = decoder.decode(probs, out_lens)
        return [d[0] for d in decoded]
