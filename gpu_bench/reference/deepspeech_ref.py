"""Plain PyTorch reference of the DanSpeech acoustic model, float32.

It follows the published DeepSpeech2 description that DanSpeech ships
(``danspeech/deepspeech/model.py``): a log1p |STFT| spectrogram (librosa's
``center=True`` reflect padding, a symmetric Hamming window, per-utterance
mean and unbiased std), the conv stack (Conv2d + eval BatchNorm + Hardtanh(0,
20)), GRU layers (eval BatchNorm before every layer but the first; two
directions summed, ``pack_padded_sequence`` semantics), the lookahead
(depthwise, right-padded with ``context - 1`` zeros, then Hardtanh) for
unidirectional models, and the head (eval BatchNorm, then Linear without
bias). It reads the published ``.pth`` state-dict layout.

It imports nothing of the program under test: only torch and numpy. Every
product runs in float32 with TF32 off. ``control=True`` rounds the operands
of every product that the program computes in bf16 (the convolutions, the
GRU input and recurrent products, the head) to fp8 e4m3 with one scale per
tensor, and accumulates in float32: the precision one step below bf16.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

# (kernel, stride, padding) along (freq, time) and channels of the three
# published conv layers
CONV_SPECS = (
    ((41, 11), (2, 2), (20, 5), 1, 32),
    ((21, 11), (2, 1), (10, 5), 32, 32),
    ((21, 11), (2, 1), (10, 5), 32, 96),
)
BN_EPS = 1e-5
FP8_MAX = 448.0  # the largest finite float8_e4m3fn


@contextlib.contextmanager
def full_float32():
    """TF32 off for matmuls and convolutions; the flags are put back after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the whole tensor, back
    in float32."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def hamming(n: int) -> torch.Tensor:
    """scipy.signal.hamming(n), symmetric, as float32."""
    k = np.arange(n)
    return torch.from_numpy((0.54 - 0.46 * np.cos(2.0 * np.pi * k / (n - 1))).astype(np.float32))


def log_spectrogram(y: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor) -> torch.Tensor:
    """(n,) float32 samples -> (n_fft // 2 + 1, 1 + n // hop) normalised log1p |STFT|."""
    half = n_fft // 2
    padded = F.pad(y[None, None], (half, half), mode="reflect")[0, 0]
    frames = padded.unfold(0, n_fft, hop) * window
    spect = torch.log1p(torch.fft.rfft(frames, dim=-1).abs()).T
    return (spect - spect.mean()) / spect.std(correction=1)


class Model:
    """The reference over a state dict in the published layout (tensors on
    one device, float32)."""

    def __init__(self, state_dict: dict, config: dict, control: bool = False):
        self.sd = {k: v.float() for k, v in state_dict.items() if v.is_floating_point()}
        self.config = config
        self.mm = fp8 if control else (lambda t: t)
        self.calibrating = False
        audio = config["audio_conf"]
        self.n_fft = int(audio["sampling_rate"] * audio["window_size"])
        self.hop = int(audio["sampling_rate"] * audio["window_stride"])
        self.device = next(iter(self.sd.values())).device
        self.window = hamming(self.n_fft).to(self.device)

    def _bn(self, x: torch.Tensor, key: str, channels: torch.Tensor = None) -> torch.Tensor:
        """Eval BatchNorm over the last axis of ``x``. While calibrating, the
        running statistics are first set to those of ``channels`` (rows of
        valid values, one column a channel), as training leaves them."""
        sd = self.sd
        if self.calibrating:
            sd[f"{key}.running_mean"].copy_(channels.mean(0))
            sd[f"{key}.running_var"].copy_(channels.var(0).clamp(min=1e-3))
        scale = sd[f"{key}.weight"] / torch.sqrt(sd[f"{key}.running_var"] + BN_EPS)
        shift = sd[f"{key}.bias"] - sd[f"{key}.running_mean"] * scale
        return x * scale + shift

    def features(self, waves: list) -> list:
        """Each utterance alone through the spectrogram and the conv stack:
        a list of (T'_i, I)."""
        xs = []
        for wave in waves:
            y = torch.from_numpy(np.asarray(wave).astype(np.float32)).to(self.device)
            xs.append(log_spectrogram(y, self.n_fft, self.hop, self.window)[None, None])
        for i, (_, stride, pad, _, _) in enumerate(CONV_SPECS[: self.config["conv_layers"]]):
            w = self.mm(self.sd[f"conv.seq_module.{3 * i}.weight"])
            bias = self.sd[f"conv.seq_module.{3 * i}.bias"]
            xs = [F.conv2d(self.mm(x), w, bias, stride, pad).movedim(1, -1) for x in xs]
            channels = torch.cat([x.reshape(-1, x.shape[-1]) for x in xs])
            xs = [self._bn(x, f"conv.seq_module.{3 * i + 1}", channels).clamp(0.0, 20.0)
                  .movedim(-1, 1) for x in xs]
        return [x[0].reshape(-1, x.shape[-1]).T for x in xs]

    def _gru(self, x: torch.Tensor, lengths: torch.Tensor, k: int) -> torch.Tensor:
        """One GRU layer over (T, N, I) from zero states, rows frozen and
        emitting zeros past their length; directions summed."""
        sd, mm = self.sd, self.mm
        suffixes = [""] + (["_reverse"] if self.config["bidirectional"] else [])
        t_max, n, _ = x.shape
        hidden = self.config["rnn_hidden_size"]
        w_hh = torch.stack([mm(sd[f"rnns.{k}.rnn.weight_hh_l0{s}"]).T for s in suffixes])
        b_hh = torch.stack([sd[f"rnns.{k}.rnn.bias_hh_l0{s}"] for s in suffixes])[:, None]
        xq = mm(x)
        gx = torch.stack([xq @ mm(sd[f"rnns.{k}.rnn.weight_ih_l0{s}"]).T
                          + sd[f"rnns.{k}.rnn.bias_ih_l0{s}"] for s in suffixes])
        dirs = len(suffixes)
        h = torch.zeros((dirs, n, hidden), device=x.device)
        out = torch.zeros((dirs, t_max, n, hidden), device=x.device)
        for step in range(t_max):
            ts = [step, t_max - 1 - step][:dirs]
            g_x = torch.stack([gx[d, t] for d, t in enumerate(ts)])
            g_h = torch.bmm(mm(h), w_hh) + b_hh
            r = torch.sigmoid(g_x[..., :hidden] + g_h[..., :hidden])
            z = torch.sigmoid(g_x[..., hidden:2 * hidden] + g_h[..., hidden:2 * hidden])
            cand = torch.tanh(g_x[..., 2 * hidden:] + r * g_h[..., 2 * hidden:])
            h_new = (1.0 - z) * cand + z * h
            live = torch.stack([(lengths > t) for t in ts])[..., None]
            h = torch.where(live, h_new, h)
            for d, t in enumerate(ts):
                out[d, t] = h_new[d] * live[d]
        return out.sum(0)

    def logits(self, waves: list) -> list:
        """Per-utterance (T'_i, classes) logits for a list of int16 or float
        waveforms, computed together over the recurrent layers."""
        cfg = self.config
        with full_float32(), torch.no_grad():
            feats = self.features(waves)
            lengths = torch.tensor([f.shape[0] for f in feats], device=self.device)
            x = torch.nn.utils.rnn.pad_sequence(feats)  # (T, N, I), zeros past lengths
            valid = torch.arange(x.shape[0], device=self.device)[:, None] < lengths[None, :]
            for k in range(cfg["rnn_layers"]):
                if k > 0:
                    x = self._bn(x, f"rnns.{k}.batch_norm.module", x[valid])
                x = self._gru(x, lengths, k)
            if not cfg["bidirectional"]:
                w = self.sd["lookahead.0.conv.weight"][:, 0]  # (H, context)
                context = w.shape[1]
                padded = F.pad(x, (0, 0, 0, 0, 0, context - 1))
                x = sum(padded[j : j + x.shape[0]] * w[:, j] for j in range(context))
                x = x.clamp(0.0, 20.0)
            x = self._bn(x, "fc.0.module.0", x[valid])
            out = self.mm(x) @ self.mm(self.sd["fc.0.module.1.weight"]).T
        return [out[: int(n), i] for i, n in enumerate(lengths.tolist())]

    def calibrate(self, waves: list) -> None:
        """Set every BatchNorm's running statistics, in the state dict given,
        to those of its input over ``waves``, layer after layer."""
        self.calibrating = True
        try:
            self.logits(waves)
        finally:
            self.calibrating = False

