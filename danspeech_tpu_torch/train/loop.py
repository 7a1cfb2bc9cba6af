"""Epoch training loop + the three entry wrappers (train, finetune,
continue).

The port of ``danspeech_tpu/train/loop.py``: manifest-driven data
(train/data.py), one wave -> loss -> update step per batch
(train/step.py:make_wave_train_step), DeepSpeech2's per-epoch LR anneal,
SpecAugment, optional layer freezing for finetuning, checkpoints, and
per-epoch greedy-WER validation. The loop runs on CUDA unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..engine import _resolve_device
from ..models import deepspeech as ds
from ..models.config import DeepSpeechConfig
from .checkpoint import restore_train_state, save_train_state
from .data import SpeechDataset, batches, steps_per_epoch
from .step import (
    TrainState,
    _resolve_mixed_precision,
    freeze_mask,
    init_train_state,
    make_optimizer,
    make_wave_train_step,
    param_leaves,
    train_state_from_params,
)


class GreedyEvaluator:
    """Greedy-decode a dataset; returns (corpus_wer_pct, transcripts).

    Corpus WER = total word edits / total reference words over the whole
    set. The forward pass runs on the device of the parameters it is given,
    with bf16 matmul weights on CUDA (the GRU kernels' dtype) and float32
    on the CPU; sample lengths pad to a bucket, as in training.
    """

    SAMPLE_BUCKET = 8000

    def __init__(self, config: DeepSpeechConfig):
        from ..features.spectrogram import AudioParser

        self.config = config
        self._parser = AudioParser(config.audio_conf)

    @torch.inference_mode()
    def _fwd(self, params, waves, lengths):
        from ..ops import stft as stft_ops

        dev = param_leaves(params)[0].device
        if dev.type == "cuda":
            params = ds.cast_matmul_weights(params)
        parser = self._parser
        spect, frame_lens = stft_ops.batched_log_spectrogram(
            torch.from_numpy(waves).to(dev), torch.from_numpy(lengths).to(dev),
            parser.n_fft, parser.hop_length, parser.window.to(dev),
        )
        probs, out_lens = ds.forward(params, self.config, spect[:, None], frame_lens)
        return probs.argmax(dim=-1).cpu().numpy(), out_lens.cpu().numpy()

    def __call__(self, params, dataset: SpeechDataset, batch_size: int = 8):
        from ..decode.greedy import collapse_batch
        from ..decode.metrics import wer as word_edits

        config = self.config
        transcripts: dict[int, str] = {}
        for start in range(0, len(dataset), batch_size):
            group = list(range(start, min(start + batch_size, len(dataset))))
            waves = [dataset.load_wave(i) for i in group]
            maxlen = max(len(w) for w in waves)
            maxlen = -(-maxlen // self.SAMPLE_BUCKET) * self.SAMPLE_BUCKET
            padded = np.zeros((len(group), maxlen), np.float32)
            lens = np.zeros((len(group),), np.int32)
            for r, w in enumerate(waves):
                padded[r, : len(w)] = w
                lens[r] = len(w)
            paths, out_lens = self._fwd(params, padded, lens)
            texts = collapse_batch(paths, out_lens, config.labels, config.blank_index)
            for i, t in zip(group, texts):
                transcripts[i] = t

        edits = words = 0
        for i, u in enumerate(dataset.utterances):
            ref = " ".join(u.transcript.lower().split())
            edits += word_edits(transcripts[i], ref)
            words += max(len(ref.split()), 1)
        return 100.0 * edits / max(words, 1), [
            transcripts[i] for i in range(len(dataset))
        ]


def evaluate_greedy(params, config: DeepSpeechConfig, dataset: SpeechDataset,
                    batch_size: int = 8):
    """One-shot convenience wrapper around :class:`GreedyEvaluator`."""
    return GreedyEvaluator(config)(params, dataset, batch_size=batch_size)


def train(
    config: DeepSpeechConfig,
    train_manifest: str,
    *,
    epochs: int = 20,
    batch_size: int = 8,
    learning_rate: float = 3e-4,
    anneal: float | None = 1.1,
    weight_decay: float = 0.0,
    augment: dict | bool | None = True,
    mixed_precision: bool | str = "auto",
    remat: bool = True,
    freeze_layers: int = 0,
    init_params=None,
    resume_dir: str | None = None,
    checkpoint_dir: str | None = None,
    val_manifest: str | None = None,
    mesh=None,
    seed: int = 0,
    log=print,
    stop_fn=None,
    device=None,
) -> TrainState:
    """Run the full training loop; returns the final TrainState.

    - ``device``: None means CUDA and raises without a GPU; ``"cpu"`` trains
      on the CPU through the kernels' plain versions.
    - ``init_params``: start from these parameters (finetune wrapper), e.g.
      a loaded inference checkpoint's; they are copied, not modified.
    - ``resume_dir``: restore the newest train state and continue (continue
      wrapper); overrides ``init_params``.
    - ``freeze_layers``: freeze the first N layers, the finetune knob.
    - ``mixed_precision`` / ``remat``: the make_wave_train_step knobs: bf16
      matmul weights (f32 masters; "auto" = on for CUDA, where False is
      refused) and per-layer recomputation of the RNN activations.
    - ``mesh``: not ported; raises (ROADMAP A13).
    - ``stop_fn(epoch, state, train_loss, val_wer) -> bool``: early-stop
      hook (also how tests bound runtime).
    """
    if config.rnn_type != "gru":
        raise NotImplementedError(
            f"rnn_type={config.rnn_type!r}: only GRU models train so far; LSTM "
            "and tanh-RNN training come with the ports of their kernels "
            "(ROADMAP B5-B9)"
        )
    if mesh is not None:
        raise NotImplementedError(
            "training over a mesh comes with the port of the parallel package "
            "(ROADMAP A13)"
        )
    dev = _resolve_device(device)
    _resolve_mixed_precision(mixed_precision, dev)  # refuses float32 on CUDA

    dataset = SpeechDataset.from_manifest(train_manifest, config.labels)
    spe = steps_per_epoch(len(dataset), batch_size)
    optimizer = make_optimizer(
        learning_rate, weight_decay=weight_decay,
        anneal=anneal, steps_per_epoch=spe if anneal else None,
    )
    if init_params is not None:
        state = train_state_from_params(init_params, optimizer, dev)
    else:
        state = init_train_state(config, optimizer, seed=seed, device=dev)
    start_epoch = 0
    if resume_dir is not None:
        state, restored_step = restore_train_state(resume_dir, state)
        start_epoch = int(restored_step) // spe
        log(f"resumed step {restored_step} (epoch {start_epoch})")

    frozen = (
        freeze_mask(state.params, freeze_layers, config)
        if freeze_layers else None
    )
    step_fn = make_wave_train_step(
        config, optimizer, frozen_mask=frozen, augment=augment,
        mixed_precision=mixed_precision, remat=remat,
    )
    val_set = (
        SpeechDataset.from_manifest(val_manifest, config.labels)
        if val_manifest else None
    )
    evaluator = GreedyEvaluator(config) if val_set is not None else None
    rng = torch.Generator().manual_seed(seed)

    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        losses = []
        for batch in batches(dataset, batch_size, epoch=epoch, seed=seed):
            state, loss = step_fn(state, *batch, rng)
            losses.append(loss)
        # one transfer per epoch: the steps above never wait for the device
        losses = [float(x) for x in torch.stack(losses).cpu()] if losses else []
        train_loss = float(np.mean(losses)) if losses else float("nan")
        val_wer = None
        if val_set is not None:
            val_wer, _ = evaluator(state.params, val_set, batch_size=batch_size)
        log(
            f"epoch {epoch}: loss {train_loss:.4f}"
            + (f"  val WER {val_wer:.2f}%" if val_wer is not None else "")
            + f"  ({time.time() - t0:.1f}s, {len(losses)} steps)"
        )
        if checkpoint_dir is not None:
            save_train_state(checkpoint_dir, state, int(state.step))
        if stop_fn is not None and stop_fn(epoch, state, train_loss, val_wer):
            log(f"early stop after epoch {epoch}")
            break
    return state


def finetune(model, train_manifest: str, *, freeze_layers: int = 0, **kw):
    """Finetune wrapper: continue from a loaded inference model's params
    (DeepSpeechModel, e.g. a loaded .dsz checkpoint)."""
    return train(
        model.config, train_manifest,
        init_params=model.params, freeze_layers=freeze_layers, **kw,
    )


def continue_training(config, train_manifest: str, resume_dir: str, **kw):
    """Continue wrapper: restore the newest train state and keep going
    (checkpoints keep writing to the same directory)."""
    kw.setdefault("checkpoint_dir", resume_dir)
    return train(config, train_manifest, resume_dir=resume_dir, **kw)


def export_model(state: TrainState, config: DeepSpeechConfig, path: str):
    """Write the trained params as a native .dsz inference checkpoint."""
    from ..models.checkpoint import save_checkpoint

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    save_checkpoint(path, config, state.params)
    return path
