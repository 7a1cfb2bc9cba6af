"""CTC loss for training.

The port of ``danspeech_tpu/train/ctc.py``. The JAX package writes the alpha
recursion in plain JAX and leaves it to XLA; here it is
``torch.nn.functional.ctc_loss`` on float32 log-softmax, the same
algorithm, against which the JAX loss is tested. Where the two differ:

- a row whose label sequence does not fit its frames (more labels, counting
  one blank between repeats, than ``logit_lengths``) has loss ``inf`` here
  and a finite value of order 1e30 in the JAX package (its log-zero is
  -1e30); its gradient is not finite here. ``zero_infinity`` is off, as the
  JAX loss does not zero such rows either;
- on CUDA the targets are passed as int64 on the device, which selects
  PyTorch's native kernel (cuDNN's CTC takes int32 targets on the host);
  its backward accumulates with atomics, so gradients can differ in the
  last bits from run to run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ctc_loss(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    blank_id: int = 0,
) -> torch.Tensor:
    """Per-example negative log-likelihood of the label sequences.

    logits: (B, T, C) unnormalized; logit_lengths: (B,); labels: (B, N)
    integer ids (padded with anything); label_lengths: (B,). A row with
    label length 0 gives the negative log-probability of all blanks.
    """
    dev = logits.device
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # (T, B, C)
    return F.ctc_loss(
        log_probs,
        labels.to(device=dev, dtype=torch.int64),
        logit_lengths.to(device=dev, dtype=torch.int64),
        label_lengths.to(device=dev, dtype=torch.int64),
        blank=blank_id,
        reduction="none",
        zero_infinity=False,
    )


def mean_ctc_loss(logits, logit_lengths, labels, label_lengths, blank_id: int = 0):
    """Batch-mean CTC loss normalized per label length (torch 'mean' parity)."""
    nll = ctc_loss(logits, logit_lengths, labels, label_lengths, blank_id)
    per = nll / label_lengths.to(nll.device).clamp(min=1)
    return per.mean()
