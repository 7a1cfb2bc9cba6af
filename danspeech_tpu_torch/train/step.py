"""Training step: CTC loss + Adam on the parameter tree.

The port of ``danspeech_tpu/train/step.py``. What differs from the JAX
package, which is functional:

- a :class:`TrainState` holds float32 master leaves that require grad and
  the ``torch.optim`` optimizer bound to them; a step updates both **in
  place** and returns the state with its step count advanced;
- every leaf of the tree is trained, as in the JAX package, the BatchNorm
  running ``mean`` and ``var`` included (they are plain leaves there, not
  buffers), so two steps of the two packages agree;
- frozen leaves are left out of the update (their gradient is dropped
  before the optimizer runs), so weight decay does not shrink them; the JAX
  package zeroes their gradients and ``optax.adamw`` still decays them;
- on CUDA the GRU kernels take bf16 only, so ``mixed_precision=False`` is
  refused there; the conv stack stays float32 under mixed precision, as in
  the JAX package (cuDNN runs float32 convolutions in TF32 unless
  ``torch.backends.cudnn.allow_tf32`` is turned off).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..engine import _resolve_device
from ..models import deepspeech as ds
from ..models.config import DeepSpeechConfig
from .ctc import ctc_loss, mean_ctc_loss


class TrainState(NamedTuple):
    params: Any  # float32 master leaves (requires_grad) on the training device
    opt_state: torch.optim.Optimizer  # bound to the leaves of ``params``
    step: int  # optimizer updates taken so far


class OptimizerSpec(NamedTuple):
    """What :func:`make_optimizer` returns: the recipe of an optimizer,
    bound to a parameter tree by :func:`init_train_state`."""

    learning_rate: float
    weight_decay: float
    anneal: float | None
    steps_per_epoch: int | None

    def lr_at(self, step: int) -> float:
        """Learning rate of update number ``step`` (0-based): the staircase
        ``learning_rate * anneal ** -(step // steps_per_epoch)``."""
        if self.anneal is None:
            return self.learning_rate
        return self.learning_rate * (1.0 / self.anneal) ** (step // self.steps_per_epoch)

    def build(self, leaves: list[torch.Tensor]) -> torch.optim.Optimizer:
        if self.weight_decay:
            return torch.optim.AdamW(leaves, lr=self.learning_rate,
                                     weight_decay=self.weight_decay)
        return torch.optim.Adam(leaves, lr=self.learning_rate)


def make_optimizer(
    learning_rate: float = 3e-4,
    weight_decay: float = 0.0,
    anneal: float | None = None,
    steps_per_epoch: int | None = None,
) -> OptimizerSpec:
    """Adam/AdamW (betas 0.9 and 0.999, eps 1e-8, as optax's), optionally
    with the DeepSpeech2-style per-epoch LR anneal (lr /= anneal after each
    epoch; pass e.g. anneal=1.1 with the dataset's steps_per_epoch)."""
    if anneal is not None and not steps_per_epoch:
        raise ValueError("anneal needs steps_per_epoch")
    return OptimizerSpec(learning_rate, weight_decay, anneal, steps_per_epoch)


def param_leaves(params) -> list[torch.Tensor]:
    """The tensors of a parameter tree, in the tree's own order."""
    leaves: list[torch.Tensor] = []
    ds.map_params(lambda t: leaves.append(t) or t, params)
    return leaves


def train_state_from_params(params, optimizer: OptimizerSpec, device=None) -> TrainState:
    """A fresh state from a parameter tree: float32 copies of its leaves on
    ``device`` (None: CUDA, raising without a GPU) that require grad, and the
    optimizer over them. The tree passed in is not modified by training."""
    dev = _resolve_device(device)
    masters = ds.map_params(
        lambda t: t.detach().to(device=dev, dtype=torch.float32, copy=True)
        .requires_grad_(True),
        params,
    )
    return TrainState(masters, optimizer.build(param_leaves(masters)), 0)


def init_train_state(
    config: DeepSpeechConfig, optimizer: OptimizerSpec, seed: int = 0, device=None
) -> TrainState:
    return train_state_from_params(ds.init_params(config, seed=seed), optimizer, device)


def _resolve_mixed_precision(mixed_precision, device: torch.device) -> bool:
    """"auto" -> bf16 matmul weights on CUDA, float32 on the CPU. Float32 on
    CUDA is refused: the GRU kernels take bf16 only (ROADMAP A6b)."""
    if mixed_precision == "auto":
        return device.type == "cuda"
    if not mixed_precision and device.type == "cuda":
        raise ValueError(
            "mixed_precision=False is not available on CUDA: the GRU kernels "
            "take bf16 only (ROADMAP A6b); train in mixed precision on the "
            "card or on device='cpu' for float32"
        )
    return bool(mixed_precision)


def loss_fn(
    params,
    config: DeepSpeechConfig,
    spect: torch.Tensor,
    frame_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    rnn_impl: str = "auto",
) -> torch.Tensor:
    logits, out_lengths = ds.forward(
        params, config, spect, frame_lengths, softmax=False, rnn_impl=rnn_impl
    )
    return mean_ctc_loss(
        logits, out_lengths, labels, label_lengths, blank_id=config.blank_index
    )


def _update(state: TrainState, optimizer: OptimizerSpec, loss, frozen_mask) -> TrainState:
    """Backward, then one optimizer update in place."""
    leaves = param_leaves(state.params)
    for p in leaves:
        p.grad = None
    loss.backward()
    if frozen_mask is not None:
        for p, frozen in zip(leaves, frozen_mask):
            if frozen:
                p.grad = None  # torch optimizers skip leaves without a gradient
    for group in state.opt_state.param_groups:
        group["lr"] = optimizer.lr_at(state.step)
    state.opt_state.step()
    return TrainState(state.params, state.opt_state, state.step + 1)


def _to_device(arrays, device):
    return [torch.as_tensor(a).to(device) for a in arrays]


def make_train_step(config: DeepSpeechConfig, optimizer: OptimizerSpec,
                    frozen_mask=None):
    """Build a train step from spectrograms (B, 1, F, T).

    ``frozen_mask``: optional list of bools, one per leaf in
    :func:`param_leaves` order (True = frozen), from :func:`freeze_mask`.
    The step updates the state's leaves and optimizer in place and returns
    (state with its step advanced, loss as a 0-d tensor).
    """

    def train_step(state: TrainState, spect, frame_lengths, labels, label_lengths):
        dev = param_leaves(state.params)[0].device
        spect, frame_lengths, labels, label_lengths = _to_device(
            (spect, frame_lengths, labels, label_lengths), dev)
        loss = loss_fn(state.params, config, spect, frame_lengths, labels,
                       label_lengths)
        return _update(state, optimizer, loss, frozen_mask), loss.detach()

    return train_step


def make_wave_train_step(
    config: DeepSpeechConfig,
    optimizer: OptimizerSpec,
    frozen_mask=None,
    augment: dict | bool | None = None,
    mixed_precision: bool | str = "auto",
    remat: bool = True,
    rnn_impl: str = "auto",
):
    """Train step from PADDED WAVEFORMS, the data pipeline's entry point.

    STFT on the device (ops/stft.py) -> optional SpecAugment
    (train/augment.py) -> forward -> row-weighted CTC mean -> backward ->
    optimizer update. Row weights (train/data.py Batch.row_weights) zero out
    the padding rows a partial trailing batch carries.

    ``augment``: None/False disables; True uses SpecAugment defaults; a dict
    passes through as spec_augment kwargs. The ``rng`` argument of the step
    (a ``torch.Generator``) is consumed only when augmentation is on.

    ``mixed_precision``: run the GRU and head products on bfloat16 weights
    (float32 masters for the optimizer; the casts are inside the autograd
    graph, so gradients come back in float32); the conv stack stays float32.
    "auto" = on for CUDA, where False is refused. ``remat``: checkpoint each
    RNN layer so the backward recomputes its forward instead of keeping its
    residuals. ``rnn_impl="plain"`` runs the GRU kernels' plain versions,
    forward and backward, to check the kernels against them.

    The step takes (state, waves, wave_lengths, labels, label_lengths,
    row_weights, rng=None) as numpy arrays or tensors, updates the state in
    place and returns (state with its step advanced, loss as a 0-d tensor).
    """
    from ..features.spectrogram import AudioParser
    from ..ops import stft as stft_ops
    from .augment import spec_augment

    parser = AudioParser(config.audio_conf)
    aug_kwargs = augment if isinstance(augment, dict) else {}

    def train_step(state: TrainState, waves, wave_lengths, labels, label_lengths,
                   row_weights, rng=None):
        params = state.params
        dev = param_leaves(params)[0].device
        use_bf16 = _resolve_mixed_precision(mixed_precision, dev)
        waves, wave_lengths, labels, label_lengths, row_weights = _to_device(
            (waves, wave_lengths, labels, label_lengths, row_weights), dev)

        with torch.no_grad():  # the features do not depend on the parameters
            spect, frame_lens = stft_ops.batched_log_spectrogram(
                waves.float(), wave_lengths, parser.n_fft, parser.hop_length,
                parser.window.to(dev),
            )
            if augment:
                spect = spec_augment(rng, spect, frame_lens, **aug_kwargs)
        if use_bf16:
            cast = ds.cast_matmul_weights(params)
            cast["conv"] = params["conv"]  # conv weights stay float32
            params = cast
        logits, out_lens = ds.forward(
            params, config, spect[:, None], frame_lens, softmax=False,
            rnn_impl=rnn_impl, rnn_remat=remat,
        )
        nll = ctc_loss(logits, out_lens, labels, label_lengths,
                       blank_id=config.blank_index)
        per = nll / label_lengths.clamp(min=1)
        w = row_weights.to(per.dtype)
        loss = (per * w).sum() / w.sum().clamp(min=1e-6)
        return _update(state, optimizer, loss, frozen_mask), loss.detach()

    return train_step


def freeze_mask(params, number_to_freeze: int, config: DeepSpeechConfig) -> list[bool]:
    """One bool per leaf in :func:`param_leaves` order, True for the leaves
    of the first N layers (conv blocks first, then RNN layers), mirroring
    the original ``freeze_layers`` semantics."""
    from ..errors import FreezingMoreLayersThanExist

    if number_to_freeze > config.conv_layers + config.rnn_layers:
        raise FreezingMoreLayersThanExist(
            "You are trying to freeze more layers than exist in the model"
        )
    layers = list(params["conv"]) + list(params["rnns"])
    frozen = {
        id(t) for layer in layers[:number_to_freeze] for t in param_leaves(layer)
    }
    return [id(t) in frozen for t in param_leaves(params)]
