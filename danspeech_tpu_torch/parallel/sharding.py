"""Placement of the parameters over the mesh's model axis, and the
optimizer whose state the model axis shards.

The port of ``danspeech_tpu/parallel/sharding.py``. :func:`param_pspecs`
keeps its rule: the gate-stacked RNN weights and biases, the lookahead taps
and the head split their hidden (or gate) dimension contiguously over
``model``; the conv stack and the RNN input BatchNorms stay whole.
:func:`shard_params` cuts this rank's pieces out of a full tree.

The JAX package computes with such sharded leaves and lets GSPMD place the
collectives. PyTorch has no GSPMD, so the model axis works otherwise here:

- inference on a mesh with ``n_model > 1`` goes through :mod:`.tp`, which
  packs gate-aligned layouts and places its collectives itself;
- training keeps the forward and backward on full parameters (every rank of
  a data row computes the same gradients) and shards the optimizer: each
  rank of the model axis owns a share of the leaves, keeps Adam's moments
  for those alone, updates them, and broadcasts them to the axis
  (:class:`ShardedOptimizer`). The step equals the unsharded one.
"""

from __future__ import annotations

import torch

from ..ops.conv import BatchNormParams, ConvParams, LookaheadParams
from .mesh import MODEL_AXIS, Mesh, Placement, broadcast

REPLICATED = Placement(None, None)


def _walk(fn, node, spec=None):
    """``fn(leaf, spec_leaf)`` over a parameter tree and a matching spec
    tree, keeping the parameter tree's structure."""
    if node is None:
        return None
    if isinstance(node, torch.Tensor):
        return fn(node, spec)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_walk(fn, v, s) for v, s in zip(node, spec)))
    if isinstance(node, dict):
        return {k: _walk(fn, v, spec[k]) for k, v in node.items()}
    if isinstance(node, list):
        return [_walk(fn, v, s) for v, s in zip(node, spec)]
    raise TypeError(f"unexpected node in params: {type(node)}")


def _rnn_dir_spec(wts):
    # w_ih (I, G*H) and w_hh (H, G*H): the gate dim; biases (G*H,)
    return type(wts)(
        w_ih=Placement(MODEL_AXIS, 1), w_hh=Placement(MODEL_AXIS, 1),
        b_ih=Placement(MODEL_AXIS, 0), b_hh=Placement(MODEL_AXIS, 0),
    )


def param_pspecs(params) -> dict:
    """A :class:`Placement` for every leaf of a DeepSpeech parameter tree."""
    whole_bn = BatchNormParams(*([REPLICATED] * 4))
    hidden_bn = BatchNormParams(*([Placement(MODEL_AXIS, 0)] * 4))
    return {
        "conv": [ConvParams(*([REPLICATED] * 6)) for _ in params["conv"]],
        "rnns": [
            {
                "bn": whole_bn if e["bn"] is not None else None,
                "fwd": _rnn_dir_spec(e["fwd"]),
                "bwd": _rnn_dir_spec(e["bwd"]) if e["bwd"] is not None else None,
            }
            for e in params["rnns"]
        ],
        "lookahead": (LookaheadParams(weight=Placement(MODEL_AXIS, 0))
                      if params["lookahead"] is not None else None),
        "fc_bn": hidden_bn,
        "fc": type(params["fc"])(weight=Placement(MODEL_AXIS, 1), bias=None),
    }


def param_shardings(mesh: Mesh, params):
    """Per leaf, the index (a tuple of slices) of this rank's piece."""
    n, k = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)

    def index(leaf, spec):
        idx = [slice(None)] * leaf.dim()
        if spec.axis == MODEL_AXIS and n > 1:
            size = leaf.shape[spec.dim]
            lo, hi = k * size // n, (k + 1) * size // n
            idx[spec.dim] = slice(lo, hi)
        return tuple(idx)

    return _walk(index, params, param_pspecs(params))


def shard_params(mesh: Mesh, params):
    """This rank's pieces of a full parameter tree, on the mesh's device."""
    return _walk(lambda leaf, idx: leaf[idx].contiguous().to(mesh.device),
                 params, param_shardings(mesh, params))


# ---------------------------------------------------------------------------
# The optimizer sharded over the model axis
# ---------------------------------------------------------------------------


def _owners(leaves: list[torch.Tensor], n: int) -> list[int]:
    """The model-axis rank that owns each leaf: the largest leaves first, each
    to the rank that owns the fewest elements so far (lowest rank on ties)."""
    load = [0] * n
    owner = [0] * len(leaves)
    for i in sorted(range(len(leaves)), key=lambda i: (-leaves[i].numel(), i)):
        r = min(range(n), key=lambda r: (load[r], r))
        owner[i] = r
        load[r] += leaves[i].numel()
    return owner


class ShardedOptimizer:
    """An optimizer over ``leaves`` whose state the mesh's model axis
    shards: this rank's optimizer (``build(owned leaves)``) holds the moments
    of the leaves it owns; :meth:`step` updates them and broadcasts every
    leaf from its owner, so all ranks of the axis leave the step with the
    same parameters. The gradients must already agree across the axis.

    ``param_groups`` are the local optimizer's (the train step sets the
    learning rate there); :meth:`state_dict` is collective over the axis and
    returns the state of one optimizer over all leaves, as an unsharded run
    writes it, and :meth:`load_state_dict` takes such a state."""

    def __init__(self, leaves: list[torch.Tensor], build, mesh: Mesh):
        n = mesh.size(MODEL_AXIS)
        if n > len(leaves):
            raise ValueError(f"{len(leaves)} leaves cannot shard over {n} ranks")
        self.mesh = mesh
        self.leaves = leaves
        self.owner = _owners(leaves, n)
        me = mesh.index(MODEL_AXIS)
        self.owned = [i for i, r in enumerate(self.owner) if r == me]
        self.local = build([leaves[i] for i in self.owned])

    @property
    def param_groups(self):
        return self.local.param_groups

    @torch.no_grad()
    def step(self):
        self.local.step()
        for i, leaf in enumerate(self.leaves):
            leaf.copy_(broadcast(leaf, self.mesh, MODEL_AXIS, self.owner[i]))

    def state_dict(self) -> dict:
        import torch.distributed as dist

        local = self.local.state_dict()
        mine = {self.owned[k]: v for k, v in local["state"].items()}
        parts = [None] * self.mesh.size(MODEL_AXIS)
        dist.all_gather_object(parts, _to_cpu(mine), group=self.mesh.group(MODEL_AXIS))
        state = {k: v for part in parts for k, v in part.items()}
        group = {k: v for k, v in local["param_groups"][0].items() if k != "params"}
        return {"state": dict(sorted(state.items())),
                "param_groups": [{**group, "params": list(range(len(self.leaves)))}]}

    def load_state_dict(self, full: dict) -> None:
        group = {k: v for k, v in full["param_groups"][0].items() if k != "params"}
        self.local.load_state_dict({
            "state": {k: full["state"][i] for k, i in enumerate(self.owned)
                      if i in full["state"]},
            "param_groups": [{**group, "params": list(range(len(self.owned)))}],
        })


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree
