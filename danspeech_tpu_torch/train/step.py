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
- ``mixed_precision=False`` on CUDA runs the recurrent kernels' float32
  variants (for every ``rnn_type``) and every product of the step, the
  convolutions and gradients included, in full float32 with TF32 off
  (``ops/precision.py``). The conv stack
  stays float32 under mixed precision, as in the JAX package (cuDNN runs
  those float32 convolutions in TF32 unless ``torch.backends.cudnn.allow_tf32``
  is turned off).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..engine import _resolve_device
from ..models import deepspeech as ds
from ..models.config import DeepSpeechConfig
from ..ops import precision
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

    def build(self, leaves: list[torch.Tensor], mesh=None):
        """The optimizer over ``leaves``; on a mesh with a model axis of
        more than one rank, one whose state that axis shards
        (``parallel.sharding.ShardedOptimizer``)."""
        if mesh is not None and mesh.size("model") > 1:
            from ..parallel.sharding import ShardedOptimizer

            return ShardedOptimizer(leaves, self.build, mesh)
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


def train_state_from_params(params, optimizer: OptimizerSpec, device=None,
                            mesh=None) -> TrainState:
    """A fresh state from a parameter tree: float32 copies of its leaves on
    ``device`` (None: CUDA, raising without a GPU; the mesh's device when a
    mesh is given) that require grad, and the optimizer over them (its state
    sharded over the mesh's model axis, :meth:`OptimizerSpec.build`). The
    tree passed in is not modified by training."""
    dev = mesh.device if mesh is not None and device is None else _resolve_device(device)
    masters = ds.map_params(
        lambda t: t.detach().to(device=dev, dtype=torch.float32, copy=True)
        .requires_grad_(True),
        params,
    )
    return TrainState(masters, optimizer.build(param_leaves(masters), mesh), 0)


def init_train_state(
    config: DeepSpeechConfig, optimizer: OptimizerSpec, seed: int = 0, device=None,
    mesh=None,
) -> TrainState:
    return train_state_from_params(ds.init_params(config, seed=seed), optimizer,
                                   device, mesh)


def _resolve_mixed_precision(mixed_precision, device: torch.device) -> bool:
    """"auto" -> bf16 matmul weights on CUDA, float32 on the CPU. False
    (float32) on CUDA runs the recurrent kernels' float32 variants."""
    if mixed_precision == "auto":
        return device.type == "cuda"
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


def _sum_grads(leaves: list[torch.Tensor], mesh) -> None:
    """Sum the leaves' gradients over the mesh's data axis, in place: one
    psum of all of them flattened into one buffer."""
    from ..parallel.mesh import DATA_AXIS, psum

    grads = [p.grad for p in leaves if p.grad is not None]
    if mesh.size(DATA_AXIS) == 1 or not grads:
        return
    flat = psum(torch.cat([g.reshape(-1) for g in grads]), mesh, DATA_AXIS)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _update(state: TrainState, optimizer: OptimizerSpec, loss, frozen_mask,
            mesh=None) -> TrainState:
    """Backward, the gradients summed over the mesh's data axis, then one
    optimizer update in place."""
    leaves = param_leaves(state.params)
    for p in leaves:
        p.grad = None
    loss.backward()
    if mesh is not None:
        _sum_grads(leaves, mesh)
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
    (state with its step advanced, loss as a 0-d tensor). It runs in
    float32 (full float32 on CUDA, the recurrent kernels' float32 variants).
    """

    def train_step(state: TrainState, spect, frame_lengths, labels, label_lengths):
        dev = param_leaves(state.params)[0].device
        spect, frame_lengths, labels, label_lengths = _to_device(
            (spect, frame_lengths, labels, label_lengths), dev)
        with precision.full_float32(dev):
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
    mesh=None,
):
    """Train step from PADDED WAVEFORMS, the data pipeline's entry point.

    STFT on the device (ops/stft.py) -> optional SpecAugment
    (train/augment.py) -> forward -> row-weighted CTC mean -> backward ->
    optimizer update. Row weights (train/data.py Batch.row_weights) zero out
    the padding rows a partial trailing batch carries.

    ``augment``: None/False disables; True uses SpecAugment defaults; a dict
    passes through as spec_augment kwargs. The ``rng`` argument of the step
    (a ``torch.Generator``) is consumed only when augmentation is on.

    ``mixed_precision``: run the RNN and head products on bfloat16 weights
    (float32 masters for the optimizer; the casts are inside the autograd
    graph, so gradients come back in float32); the conv stack stays float32.
    "auto" = on for CUDA, off on the CPU. False on CUDA trains in float32:
    the recurrent kernels' float32 variants forward (and in the remat replay)
    and backward, every product in full float32 with TF32 off. ``remat``:
    checkpoint each
    RNN layer so the backward recomputes its forward instead of keeping its
    residuals. ``rnn_impl="plain"`` runs the recurrent kernels' plain versions,
    forward and backward, to check the kernels against them.

    ``mesh`` (``parallel.make_mesh``): data parallelism. The step is given
    this rank's rows (``data.shard_batch``); the loss stays the weighted
    mean over the GLOBAL batch, ``sum(per * w) / max(sum(w), 1e-6)``: each
    rank divides its numerator by the psum of the weights, the gradients are
    summed over the data axis, and the returned loss is the psum of the
    ranks' shares. A plain mean of per-rank means would weigh a rank of
    padding rows like a full one. The optimizer's state is sharded over the
    model axis (:func:`train_state_from_params`).

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
        with precision.full_float32(dev, not use_bf16):
            return _wave_step(state, params, dev, use_bf16, waves, wave_lengths,
                              labels, label_lengths, row_weights, rng)

    def _wave_step(state, params, dev, use_bf16, waves, wave_lengths, labels,
                   label_lengths, row_weights, rng):
        """The step on tensors on ``dev``, inside the precision scope."""
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
        if mesh is None:
            loss = (per * w).sum() / w.sum().clamp(min=1e-6)
            return _update(state, optimizer, loss, frozen_mask), loss.detach()
        from ..parallel.mesh import DATA_AXIS, psum

        share = (per * w).sum() / psum(w.sum(), mesh, DATA_AXIS).clamp(min=1e-6)
        state = _update(state, optimizer, share, frozen_mask, mesh)
        return state, psum(share.detach(), mesh, DATA_AXIS)

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
