"""Batch-aware automatic beam-backend selection.

The port of ``danspeech_tpu.decode.beam_auto``. The device beam's frame
loop costs about the same at any batch size, so it only pays off once
enough batch rows amortize it; below that the host C++ beam is faster.
This wrapper owns BOTH backends lazily and picks per decode call by batch
size against a crossover measured on the card (``chip_smoke.py``), so
"auto" takes each pinned backend where it wins — the batch-aware default
the reference cannot express (its ctcdecode backend is fixed at
construction, DanSpeechRecognizer.py:88-92).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .greedy import Decoder

# Batch size at and above which the device beam wins, measured by
# chip_smoke.py (phase 8, the decode alone at T=401, beam 64, a 3-gram LM)
# on an NVIDIA H100 80GB HBM3 at 700 W in three runs: the device beam takes
# 1.6-3.0 s a call at any batch from 1 to 128, the C++ host beam 57-105 ms
# a row; at B=16 the host wins (0.99-1.65 s against 1.71-2.47), from B=32
# the device (1.58-2.43 s against 2.25-2.97). Override per instance or with
# DANSPEECH_TPU_BEAM_CROSSOVER.
DEFAULT_CROSSOVER = 32


def _crossover_default() -> int:
    v = os.environ.get("DANSPEECH_TPU_BEAM_CROSSOVER")
    return int(v) if v else DEFAULT_CROSSOVER


class AutoBeamDecoder(Decoder):
    """Dispatch each decode to the host C++ beam (small batches) or the
    on-device fused beam (large batches).

    Both backends produce identical transcripts, so switching per call is
    free of accuracy consequences. Backends construct lazily — a server
    that only ever sees one regime never builds (or packs) the other. The
    device beam runs on ``device`` (``None`` means CUDA), where
    ``device_lm`` must live.
    """

    supports_n_best = True  # decode() accepts n_best; host path ignores it

    def __init__(
        self,
        labels: str,
        lm,
        device_lm,
        alpha: float,
        beta: float,
        beam_width: int,
        blank_index: int = 0,
        crossover: int | None = None,
        num_processes: int = 6,
        cutoff_top_n: int = 40,
        cutoff_prob: float = 1.0,
        device=None,
    ):
        super().__init__(labels, blank_index)
        self.lm = lm
        self.device_lm = device_lm
        self.alpha = alpha
        self.beta = beta
        self.beam_width = beam_width
        self.crossover = (
            crossover if crossover is not None else _crossover_default()
        )
        self.num_processes = num_processes
        self.cutoff_top_n = cutoff_top_n
        self.cutoff_prob = cutoff_prob
        self.device = device
        self._host = None
        self._device = None

    # -- lazy backends --------------------------------------------------
    def _host_decoder(self):
        if self._host is None:
            from .beam import BeamCTCDecoder

            self._host = BeamCTCDecoder(
                labels=self.labels,
                lm_path=self.lm,
                alpha=self.alpha,
                beta=self.beta,
                beam_width=self.beam_width,
                num_processes=self.num_processes,
                cutoff_prob=self.cutoff_prob,
                cutoff_top_n=self.cutoff_top_n,
                blank_index=self.blank_index,
            )
        return self._host

    def _device_decoder(self):
        if self._device is None:
            from .device_beam import DeviceBeamDecoder

            self._device = DeviceBeamDecoder(
                labels=self.labels,
                beam_width=self.beam_width,
                blank_index=self.blank_index,
                lm=self.device_lm,
                alpha=self.alpha,
                beta=self.beta,
                device=self.device,
            )
        return self._device

    def for_batch(self, batch_size: int):
        """The concrete decoder for a ``batch_size``-row dispatch group —
        the engine resolves per group so a mixed workload rides each
        backend where it wins."""
        if batch_size >= self.crossover:
            return self._device_decoder()
        return self._host_decoder()

    def decode(self, probs, sizes=None, n_best: int | None = None):
        """Standalone decode: resolve by the probs batch dimension.

        The engine path resolves earlier (``for_batch``) to keep the
        probabilities on the device for the device backend and slice
        padding rows before the host backend; callers coming through here
        get the same routing with a host copy when the host backend wins.
        """
        decoder = self.for_batch(int(probs.shape[0]))
        if getattr(decoder, "supports_n_best", False):
            return decoder.decode(probs, sizes, n_best=n_best)
        if isinstance(probs, torch.Tensor):
            probs = probs.cpu()
        return decoder.decode(np.asarray(probs), sizes)
