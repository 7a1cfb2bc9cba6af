"""Plain PyTorch reference of deepspeech.pytorch's bidirectional LSTM
DeepSpeech2, float32.

It follows ``deepspeech_pytorch/model.py`` (``DeepSpeech``, ``BatchRNN``,
``MaskConv``) at the widths of ``configs/train_config.py``
``BiDirectionalConfig``: the log1p |STFT| spectrogram, two Conv2d layers of
32 channels, each with eval BatchNorm2d and Hardtanh(0, 20), then LSTM layers
(eval BatchNorm before every layer but the first; the two directions
summed, ``pack_padded_sequence`` semantics: a row's state freezes past its
length, the reverse direction starts at the row's own last frame), and the
head (eval BatchNorm1d, then Linear without bias). It reads the state dict
as ``nn.LSTM`` and ``nn.BatchNorm`` save it: ``rnns.k.rnn.weight_ih_l0``
(4H, I) and ``weight_hh_l0`` (4H, H), contiguous, gate order i, f, g, o,
``_reverse`` for the second direction.

The features, the conv stack, BatchNorm and the head are those of
:mod:`reference.deepspeech_ref`, which follows DanSpeech's copy of the same
model; only the recurrent layer differs. It imports nothing of the program
under test: only torch and numpy. Every product runs in float32 with TF32
off. ``control=True`` rounds the operands of every product that the program
computes in bf16 (the convolutions, the LSTM input and recurrent products,
the head) to fp8 e4m3 with one scale per tensor, and accumulates in float32.

Departures from deepspeech.pytorch, all the benchmark's:

- the weights are random from a seed, not the released LibriSpeech ones;
- BatchNorm's running statistics come from a calibration batch
  (:meth:`Model.calibrate`), not from training;
- the head's weight carries the configuration's ``head_gain``;
- the labels are those of its ``labels.json`` (29, upper case), so nothing
  is lower-cased.
"""

from __future__ import annotations

import torch

from reference.deepspeech_ref import Model as _DeepSpeech2


class Model(_DeepSpeech2):
    """The reference over a state dict in ``nn.LSTM``'s layout (tensors on
    one device, float32). :meth:`logits` and :meth:`calibrate` are the base
    class's; its recurrent layer is the LSTM below."""

    def _gru(self, x: torch.Tensor, lengths: torch.Tensor, k: int) -> torch.Tensor:
        """The base class's recurrent layer, here LSTM layer ``k`` over
        (T, N, I) from zero states: c' = f c + i g, h' = o tanh(c'), rows
        frozen and emitting zeros past their length; directions summed."""
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
        c = torch.zeros_like(h)
        out = torch.zeros((dirs, t_max, n, hidden), device=x.device)
        for step in range(t_max):
            ts = [step, t_max - 1 - step][:dirs]
            g_x = torch.stack([gx[d, t] for d, t in enumerate(ts)])
            pre = g_x + torch.bmm(mm(h), w_hh) + b_hh
            i, f, g, o = pre.split(hidden, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            live = torch.stack([(lengths > t) for t in ts])[..., None]
            h = torch.where(live, h_new, h)
            c = torch.where(live, c_new, c)
            for d, t in enumerate(ts):
                out[d, t] = h_new[d] * live[d]
        return out.sum(0)
