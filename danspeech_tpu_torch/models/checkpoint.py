"""Checkpoint import/export: the weight bridge.

The port of ``danspeech_tpu/models/checkpoint.py``. Parameters cross
between the two packages, and to and from disk, as a reference-named
state_dict of numpy arrays (the original danspeech ``DeepSpeech`` module's
key names, RNN weights in torch's (G·H, I) layout, G = 3, 4 or 1 for
``rnn_type`` "gru", "lstm" or "rnn"). Two formats on disk funnel through
:func:`params_from_state_dict`:

1. the zoo's ``.pth`` packages (the original ``DeepSpeech.load_model``
   layout: hyperparameters beside a ``state_dict``), read by
   :func:`~.torch_pickle.torch_load` (``torch.load`` with
   ``weights_only=True``);
2. the native ``.dsz`` format: that dict as an ``.npz`` plus a JSON config
   inside one zip.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch

from ..ops.conv import BatchNormParams, ConvParams, LinearParams, LookaheadParams
from .config import DeepSpeechConfig
from .deepspeech import RNN_WEIGHTS_CLS, Params
from .torch_pickle import torch_load


def _t(x, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True)).to(dtype)


def _numpy(v) -> np.ndarray:
    """A state_dict value as numpy; floating tensors (bf16 included) as
    float32."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.is_floating_point() else v).numpy()
    return np.asarray(v)


def params_from_state_dict(
    state_dict: dict, config: DeepSpeechConfig, dtype=torch.float32
) -> Params:
    """Map a reference-named state_dict of numpy arrays onto the port's
    parameter tree, on the CPU.

    Keys: conv block i at ``conv.seq_module.{3i}`` (conv) and ``.{3i+1}``
    (BN); RNN layer k at ``rnns.k.rnn.*`` with its pre-BN at
    ``rnns.k.batch_norm.module.*`` for k >= 1; lookahead at
    ``lookahead.0.conv.weight`` (batch) or ``lookahead.conv.weight``
    (streaming); head at ``fc.0.module.{0,1}``.
    Values may be numpy arrays or CPU tensors of any floating dtype (a
    package's tensors); keys nothing reads, such as BatchNorm's
    ``num_batches_tracked``, are ignored.
    """
    sd = {k: _numpy(v) for k, v in state_dict.items()}

    convs = []
    for i in range(config.conv_layers):
        base = f"conv.seq_module.{3 * i}"
        bn = f"conv.seq_module.{3 * i + 1}"
        convs.append(
            ConvParams(
                weight=_t(sd[f"{base}.weight"], dtype),
                bias=_t(sd[f"{base}.bias"], dtype),
                bn_gamma=_t(sd[f"{bn}.weight"], dtype),
                bn_beta=_t(sd[f"{bn}.bias"], dtype),
                bn_mean=_t(sd[f"{bn}.running_mean"], dtype),
                bn_var=_t(sd[f"{bn}.running_var"], dtype),
            )
        )

    wcls = RNN_WEIGHTS_CLS[config.rnn_type]

    def rnn_dir(k: int, suffix: str):
        return wcls(
            w_ih=_t(sd[f"rnns.{k}.rnn.weight_ih_l0{suffix}"].T, dtype),
            w_hh=_t(sd[f"rnns.{k}.rnn.weight_hh_l0{suffix}"].T, dtype),
            b_ih=_t(sd[f"rnns.{k}.rnn.bias_ih_l0{suffix}"], dtype),
            b_hh=_t(sd[f"rnns.{k}.rnn.bias_hh_l0{suffix}"], dtype),
        )

    rnns = []
    for k in range(config.rnn_layers):
        bn_key = f"rnns.{k}.batch_norm.module"
        bn = None
        if f"{bn_key}.weight" in sd:
            bn = BatchNormParams(
                gamma=_t(sd[f"{bn_key}.weight"], dtype),
                beta=_t(sd[f"{bn_key}.bias"], dtype),
                mean=_t(sd[f"{bn_key}.running_mean"], dtype),
                var=_t(sd[f"{bn_key}.running_var"], dtype),
            )
        bwd = None
        if config.bidirectional and not config.streaming_model:
            bwd = rnn_dir(k, "_reverse")
        rnns.append({"bn": bn, "fwd": rnn_dir(k, ""), "bwd": bwd})

    look = None
    if not config.bidirectional or config.streaming_model:
        w = sd.get("lookahead.0.conv.weight")
        if w is None:
            w = sd["lookahead.conv.weight"]
        look = LookaheadParams(weight=_t(w.reshape(w.shape[0], w.shape[-1]), dtype))

    return {
        "conv": convs,
        "rnns": rnns,
        "lookahead": look,
        "fc_bn": BatchNormParams(
            gamma=_t(sd["fc.0.module.0.weight"], dtype),
            beta=_t(sd["fc.0.module.0.bias"], dtype),
            mean=_t(sd["fc.0.module.0.running_mean"], dtype),
            var=_t(sd["fc.0.module.0.running_var"], dtype),
        ),
        "fc": LinearParams(weight=_t(sd["fc.0.module.1.weight"], dtype), bias=None),
    }


def state_dict_from_params(params: Params, config: DeepSpeechConfig) -> dict:
    """Inverse mapping: parameter tree -> reference-named numpy state_dict
    (float32)."""

    def n(t):
        return t.detach().float().cpu().numpy()

    sd: dict[str, np.ndarray] = {}
    for i, c in enumerate(params["conv"]):
        base = f"conv.seq_module.{3 * i}"
        bn = f"conv.seq_module.{3 * i + 1}"
        sd[f"{base}.weight"] = n(c.weight)
        sd[f"{base}.bias"] = n(c.bias)
        sd[f"{bn}.weight"] = n(c.bn_gamma)
        sd[f"{bn}.bias"] = n(c.bn_beta)
        sd[f"{bn}.running_mean"] = n(c.bn_mean)
        sd[f"{bn}.running_var"] = n(c.bn_var)
    for k, entry in enumerate(params["rnns"]):
        if entry["bn"] is not None:
            bn_key = f"rnns.{k}.batch_norm.module"
            sd[f"{bn_key}.weight"] = n(entry["bn"].gamma)
            sd[f"{bn_key}.bias"] = n(entry["bn"].beta)
            sd[f"{bn_key}.running_mean"] = n(entry["bn"].mean)
            sd[f"{bn_key}.running_var"] = n(entry["bn"].var)
        for suffix, w in (("", entry["fwd"]), ("_reverse", entry["bwd"])):
            if w is None:
                continue
            sd[f"rnns.{k}.rnn.weight_ih_l0{suffix}"] = n(w.w_ih).T
            sd[f"rnns.{k}.rnn.weight_hh_l0{suffix}"] = n(w.w_hh).T
            sd[f"rnns.{k}.rnn.bias_ih_l0{suffix}"] = n(w.b_ih)
            sd[f"rnns.{k}.rnn.bias_hh_l0{suffix}"] = n(w.b_hh)
    if params["lookahead"] is not None:
        w = n(params["lookahead"].weight)
        key = "lookahead.conv.weight" if config.streaming_model else "lookahead.0.conv.weight"
        sd[key] = w.reshape(w.shape[0], 1, w.shape[1])
    sd["fc.0.module.0.weight"] = n(params["fc_bn"].gamma)
    sd["fc.0.module.0.bias"] = n(params["fc_bn"].beta)
    sd["fc.0.module.0.running_mean"] = n(params["fc_bn"].mean)
    sd["fc.0.module.0.running_var"] = n(params["fc_bn"].var)
    sd["fc.0.module.1.weight"] = n(params["fc"].weight)
    return sd


def config_from_package(package: dict) -> DeepSpeechConfig:
    """A config from a package's hyperparameters (the keys the original
    ``DeepSpeech.load_model`` reads; labels as a string or a list)."""
    labels = package["labels"]
    if isinstance(labels, (list, tuple)):
        labels = "".join(labels)
    return DeepSpeechConfig(
        model_name=str(package["model_name"]),
        rnn_hidden_size=int(package["rnn_hidden_size"]),
        rnn_layers=int(package["rnn_layers"]),
        labels=str(labels),
        audio_conf=dict(package["audio_conf"]),
        rnn_type=str(package["rnn_type"]),
        bidirectional=bool(package["bidirectional"]),
        conv_layers=int(package["conv_layers"]),
        context=int(package["context"]),
        streaming_model=bool(package["streaming_model"]),
    )


def load_reference_checkpoint(path) -> tuple[DeepSpeechConfig, Params]:
    """Load a zoo ``.pth`` package (zip or legacy format) onto the CPU."""
    package = torch_load(path)
    config = config_from_package(package)
    return config, params_from_state_dict(package["state_dict"], config)


# ---------------------------------------------------------------------------
# Trees by leaf name: parameters, gradients and optimizer moments cross to
# and from the JAX package's parameter tree, which has the same structure,
# field names and layouts
# ---------------------------------------------------------------------------


def flatten_tree(tree) -> dict:
    """A parameter-shaped tree (parameters, or their gradients) as a flat
    {leaf name: float32 numpy array}: names are the tree's keys, list
    indices and NamedTuple fields joined by dots (``conv.0.bn_mean``,
    ``rnns.1.bwd.w_hh``, ``fc_bn.var``), the paths of the JAX package's
    tree. ``None`` nodes are skipped."""
    flat: dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if node is None:
            return
        if isinstance(node, torch.Tensor):
            # a copy: the arrays must not follow later in-place updates
            flat[prefix] = np.array(node.detach().float().cpu().numpy(), copy=True)
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for name, v in zip(node._fields, node):
                walk(v, f"{prefix}.{name}")
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else str(k))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}.{i}")
        else:
            raise TypeError(f"unexpected node at {prefix!r}: {type(node)}")

    walk(tree, "")
    return flat


def unflatten_tree(flat: dict, like: Params, dtype=torch.float32) -> Params:
    """Inverse of :func:`flatten_tree`: a tree with the structure of
    ``like`` whose leaves are CPU tensors made from ``flat``'s arrays."""

    def walk(node, prefix):
        if node is None:
            return None
        if isinstance(node, torch.Tensor):
            leaf = _t(flat[prefix], dtype)
            if leaf.shape != node.shape:
                raise ValueError(f"{prefix}: shape {tuple(leaf.shape)}, expected "
                                 f"{tuple(node.shape)}")
            return leaf
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v, f"{prefix}.{name}")
                                for name, v in zip(node._fields, node)))
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}.{k}" if prefix else str(k))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{prefix}.{i}") for i, v in enumerate(node)]
        raise TypeError(f"unexpected node at {prefix!r}: {type(node)}")

    return walk(like, "")


# ---------------------------------------------------------------------------
# Native format (.dsz): npz arrays + config.json inside one zip
# ---------------------------------------------------------------------------


def save_checkpoint(path: str, config: DeepSpeechConfig, params: Params) -> None:
    sd = state_dict_from_params(params, config)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("config.json", json.dumps(config.to_dict()))
        buf = io.BytesIO()
        np.savez(buf, **sd)
        zf.writestr("weights.npz", buf.getvalue())


def load_checkpoint(path: str) -> tuple[DeepSpeechConfig, Params]:
    with zipfile.ZipFile(path, "r") as zf:
        config = DeepSpeechConfig.from_dict(json.loads(zf.read("config.json")))
        with np.load(io.BytesIO(zf.read("weights.npz"))) as npz:
            sd = {k: npz[k] for k in npz.files}
    return config, params_from_state_dict(sd, config)
