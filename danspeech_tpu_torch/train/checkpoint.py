"""Training checkpoint / resume.

The port of ``danspeech_tpu/train/checkpoint.py``: the train state
(parameters, optimizer state and step count) persists under
``ckpt_dir/step_<N>``, the JAX package's names, written by ``torch.save``
and read by ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import os

import torch

from ..models.checkpoint import flatten_tree
from .step import TrainState, param_leaves

_FILE = "state.pt"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def save_train_state(ckpt_dir: str, state: TrainState, step: int) -> str:
    """Write ``state`` under ``ckpt_dir/step_<N>``; returns the path."""
    path = _step_dir(ckpt_dir, step)
    os.makedirs(path, exist_ok=True)
    payload = {
        "params": {k: torch.from_numpy(v) for k, v in flatten_tree(state.params).items()},
        "opt_state": state.opt_state.state_dict(),
        "step": int(state.step),
    }
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _FILE))  # a reader sees all or none
    return path


def latest_step(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and d.split("_")[1].isdigit()
        and os.path.isfile(os.path.join(ckpt_dir, d, _FILE))
    ]
    return max(steps) if steps else None


def restore_train_state(ckpt_dir: str, like: TrainState, step=None) -> tuple:
    """Restore (state, step) from the newest (or given) checkpoint.

    ``like`` provides the parameter tree and the optimizer: its leaves and
    its optimizer's state are overwritten in place, on their device.
    """
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    payload = torch.load(os.path.join(_step_dir(ckpt_dir, step), _FILE),
                         map_location="cpu", weights_only=True)
    names = list(flatten_tree(like.params))
    leaves = param_leaves(like.params)
    if set(names) != set(payload["params"]):
        raise ValueError(
            f"checkpoint step {step} holds another parameter tree: "
            f"{sorted(set(names) ^ set(payload['params']))[:4]} ..."
        )
    with torch.no_grad():
        for name, leaf in zip(names, leaves):
            leaf.copy_(payload["params"][name])
    like.opt_state.load_state_dict(payload["opt_state"])
    return TrainState(like.params, like.opt_state, int(payload["step"])), step
