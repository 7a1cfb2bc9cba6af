"""Plain PyTorch reference of Mozilla DeepSpeech 0.9.3, float32.

It follows the release (github.com/mozilla/DeepSpeech, tag v0.9.3):
``util/feeding.py`` ``audio_to_features`` (TensorFlow's ``audio_spectrogram``
with ``magnitude_squared=True``, window 512 and stride 320 samples, then its
``mfcc`` with 26 coefficients, 40 channels from 20 Hz to 8 kHz, as
``spectrogram.cc``, ``mfcc_mel_filterbank.cc`` and ``mfcc_dct.cc`` compute
them), then ``train.py`` ``create_overlapping_windows`` (n_context 9) and
``create_model``: ``dense`` layers 1-3 clipped at ``relu_clip`` 20, the
``LSTMBlockFusedCell`` (``forget_bias=0``) of ``rnn_impl_lstmblockfusedcell``,
``layer_5`` clipped, ``layer_6`` linear. It reads the release's variables as
TensorFlow names them: ``layer_k/weights`` (in, out) and ``layer_k/bias``,
and the LSTM's ``kernel`` (I + H, 4H), rows [x; h], in TensorFlow's gate
order i, c~, f, o, with its ``bias`` (4H,). The recurrence is a loop over
steps in that order, the state of a row frozen past its length.

Each utterance's features are computed alone; the dense layers and the LSTM
run over blocks of rows padded with zero frames. It imports nothing of the
program under test: only torch and numpy. Every product runs in float32
with TF32 off. ``control=True`` rounds the operands of every product that the
program computes in bf16 (the dense layers, the LSTM's kernel and its
[x; h], ``layer_6``) to fp8 e4m3 with one scale per tensor, and accumulates
in float32: the precision one step below bf16.

Departures from the release, all the benchmark's: the weights are random
from a seed, not the released checkpoint; ``layer_6``'s weights carry the
configuration's ``head_gain``; there is no language model.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.deepspeech_ref import fp8, full_float32

SAMPLE_RATE = 16000
WINDOW, HOP = 512, 320
CHANNELS, COEFFICIENTS = 40, 26
LOWER_HZ, UPPER_HZ = 20.0, 8000.0
N_CONTEXT = 9
RELU_CLIP = 20.0
LSTM_SCOPE = "cudnn_lstm/rnn/multi_rnn_cell/cell_0/cudnn_compatible_lstm_cell"


def _mel(freq: float) -> float:
    return 1127.0 * math.log1p(freq / 700.0)


def _filterbank_plan(bins: int):
    """``MfccMelFilterbank::Initialize``: per bin, the channel of its right
    slope (-1 below the first centre, -2 unused) and its weight there."""
    mel_low, mel_high = _mel(LOWER_HZ), _mel(UPPER_HZ)
    spacing = (mel_high - mel_low) / (CHANNELS + 1)
    centres = [mel_low + spacing * (i + 1) for i in range(CHANNELS + 1)]
    hz_per_bin = 0.5 * SAMPLE_RATE / (bins - 1)
    start = int(1.5 + LOWER_HZ / hz_per_bin)
    end = int(UPPER_HZ / hz_per_bin)
    band, weights = [], []
    channel = 0
    for i in range(bins):
        melf = _mel(i * hz_per_bin)
        if i < start or i > end:
            band.append(-2)
            weights.append(0.0)
            continue
        while channel < CHANNELS and centres[channel] < melf:
            channel += 1
        c = channel - 1
        band.append(c)
        if c >= 0:
            weights.append((centres[c + 1] - melf) / (centres[c + 1] - centres[c]))
        else:
            weights.append((centres[0] - melf) / (centres[0] - mel_low))
    return start, end, band, weights


class Model:
    """The reference over a state dict of the release's variables (tensors on
    one device, float32)."""

    def __init__(self, state_dict: dict, config: dict, control: bool = False):
        self.sd = {k: v.float() for k, v in state_dict.items()}
        self.config = config
        self.mm = fp8 if control else (lambda t: t)
        self.device = next(iter(self.sd.values())).device
        n = torch.arange(WINDOW, dtype=torch.float64)
        self.window = (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / WINDOW)).float().to(self.device)
        start, end, band, weights = _filterbank_plan(WINDOW // 2 + 1)
        self.bins = torch.arange(start, end + 1, device=self.device)
        self.band = torch.tensor(band[start : end + 1], device=self.device)
        self.weight = torch.tensor(weights[start : end + 1], dtype=torch.float32,
                                   device=self.device)
        i = torch.arange(COEFFICIENTS, dtype=torch.float64)[:, None]
        j = torch.arange(CHANNELS, dtype=torch.float64)[None, :]
        self.cosines = (math.sqrt(2.0 / CHANNELS)
                        * torch.cos(math.pi / CHANNELS * i * (j + 0.5))).float().to(self.device)

    def features(self, wave) -> torch.Tensor:
        """One utterance's (T, 26) MFCC: whole windows of the int16 samples
        over 32768, |DFT|^2, the mel channels of the bins' magnitudes (each
        bin adding weight x magnitude to its channel and the rest to the
        next), log with the 1e-12 floor, the DCT."""
        y = torch.from_numpy(np.asarray(wave).astype(np.float32) / 32768.0).to(self.device)
        if y.shape[0] < WINDOW:
            return torch.zeros((0, COEFFICIENTS), device=self.device)
        frames = y.unfold(0, WINDOW, HOP) * self.window
        spec = torch.fft.rfft(frames, n=WINDOW, dim=-1)
        mag = (spec.real ** 2 + spec.imag ** 2).sqrt()[:, self.bins]  # (T, bins used)
        out = torch.zeros((frames.shape[0], CHANNELS + 1), device=self.device)
        right = self.band.clamp(min=0)
        out.index_add_(1, right, mag * self.weight * (self.band >= 0))
        out.index_add_(1, self.band + 1, mag * (1.0 - self.weight))
        channels = out[:, :CHANNELS].clamp(min=1e-12).log()
        return channels @ self.cosines.T

    def _dense(self, x: torch.Tensor, name: str, clip: bool = True) -> torch.Tensor:
        y = self.mm(x) @ self.mm(self.sd[f"{name}/weights"]) + self.sd[f"{name}/bias"]
        return y.clamp(0.0, RELU_CLIP) if clip else y

    def _lstm(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """(T, N, I) -> (T, N, H) from zero states, TensorFlow's gate order:
        [x; h] @ kernel + bias = i, c~, f, o; c' = sigmoid(f) c +
        sigmoid(i) tanh(c~), h' = sigmoid(o) tanh(c'); rows frozen and
        emitting zeros past their length."""
        kernel = self.mm(self.sd[f"{LSTM_SCOPE}/kernel"])
        bias = self.sd[f"{LSTM_SCOPE}/bias"]
        t_max, n, width = x.shape
        hidden = kernel.shape[1] // 4
        gx = self.mm(x) @ kernel[:width]
        h = torch.zeros((n, hidden), device=x.device)
        c = torch.zeros_like(h)
        out = torch.zeros((t_max, n, hidden), device=x.device)
        for t in range(t_max):
            pre = gx[t] + self.mm(h) @ kernel[width:] + bias
            i, ci, f, o = pre.split(hidden, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(ci)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            live = (lengths > t)[:, None]
            h = torch.where(live, h_new, h)
            c = torch.where(live, c_new, c)
            out[t] = h_new * live
        return out

    def _windows(self, feats: torch.Tensor) -> torch.Tensor:
        """(T, N, 26) -> (T, N, 19 x 26): frame t's [f(t - 9), ..., f(t + 9)],
        zeros outside [0, T)."""
        t_max = feats.shape[0]
        parts = []
        for k in range(-N_CONTEXT, N_CONTEXT + 1):
            shifted = torch.zeros_like(feats)
            lo, hi = max(0, -k), min(t_max, t_max - k)
            if hi > lo:
                shifted[lo:hi] = feats[lo + k : hi + k]
            parts.append(shifted)
        return torch.cat(parts, dim=-1)

    def logits(self, waves: list, block: int = 16) -> list:
        """Per-utterance (T_i, classes) logits for a list of int16 waveforms,
        ``block`` rows at a time over the dense layers and the LSTM."""
        out = []
        with full_float32(), torch.no_grad():
            feats = [self.features(w) for w in waves]
            for at in range(0, len(feats), block):
                part = feats[at : at + block]
                lengths = torch.tensor([f.shape[0] for f in part], device=self.device)
                # zeros past each row's length: the windows read them
                x = self._windows(torch.nn.utils.rnn.pad_sequence(part))
                for name in ("layer_1", "layer_2", "layer_3"):
                    x = self._dense(x, name)
                x = self._lstm(x, lengths)
                x = self._dense(self._dense(x, "layer_5"), "layer_6", clip=False)
                out += [x[: int(n), i] for i, n in enumerate(lengths.tolist())]
        return out
