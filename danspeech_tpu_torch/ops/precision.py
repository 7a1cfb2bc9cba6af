"""Full float32 on CUDA: the float32 modes' products without TF32.

PyTorch runs a float32 matrix product on CUDA in full float32 by default,
but a float32 convolution through cuDNN in TF32 (``torch.backends.cudnn.
allow_tf32`` is True), and a caller may have allowed TF32 for products too
(``torch.set_float32_matmul_precision("high")``). TF32 keeps 10 mantissa
bits. The float32 modes (``compute_dtype="float32"`` serving,
``mixed_precision=False`` training) promise float32 results, so every
product they run on CUDA, the convolutions, projections, head and gradients
included, runs inside :func:`full_float32`, which turns TF32 off and puts the
caller's settings back on leaving. Mixed precision and bf16 serving never
enter it.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
_depth = 0      # scopes open in the process
_saved = None   # the caller's settings, taken by the first scope to open


def _enter() -> None:
    global _depth, _saved
    with _lock:
        if _depth == 0:
            _saved = (torch.get_float32_matmul_precision(),
                      torch.backends.cudnn.allow_tf32)
            torch.set_float32_matmul_precision("highest")
            torch.backends.cudnn.allow_tf32 = False
        _depth += 1


def _leave() -> None:
    global _depth, _saved
    with _lock:
        _depth -= 1
        if _depth == 0:
            torch.set_float32_matmul_precision(_saved[0])
            torch.backends.cudnn.allow_tf32 = _saved[1]
            _saved = None


@contextlib.contextmanager
def full_float32(device, enabled: bool = True):
    """Inside: float32 matrix products (cuBLAS) and convolutions (cuDNN) on
    CUDA in full float32, TF32 off. On leaving the last scope open in the
    process (scopes nest and may overlap across threads), the caller's
    ``torch.get_float32_matmul_precision()`` and
    ``torch.backends.cudnn.allow_tf32`` come back. A no-op for a device
    other than CUDA or when ``enabled`` is False.

    The flags are the process's, not the thread's: while any scope is open,
    every thread of the process runs its float32 products and convolutions
    without TF32, in or out of a scope, and a thread that sets the flags
    meanwhile has its setting overwritten when the last scope closes (or,
    if it allows TF32, puts the open scopes' products into TF32)."""
    if not enabled or torch.device(device).type != "cuda":
        yield
        return
    _enter()
    try:
        yield
    finally:
        _leave()
