"""Tensor parallelism for the GRU stack over the mesh's model axis.

The port of ``danspeech_tpu/parallel/tp.py``, with its two recurrence
modes:

- **direction** (bidirectional models on a 2-way axis): rank 0 runs every
  layer's forward chain and rank 1 its backward chain, each as one
  ``gru_scan`` launch on the direction's full (H, 3H) weights over the whole
  sequence (the backward chain walks time in reverse); one ``psum`` per layer
  sums the directions;
- **hidden** (any n): :func:`pack_tp_params` permutes every gate-stacked
  weight's 3H columns into shard-grouped order, so rank ``k`` holds the
  gate-aligned (H, 3H/n) columns of its h-slice; each step multiplies the
  whole ``h`` by the local columns, runs the gate math on the slice, and
  ONE ``all_gather`` of (D, B, H/n) reassembles ``h``. The JAX package runs
  that recurrence as a ``lax.scan``, not a kernel (a per-step exchange
  cannot live inside one), so it is a loop of tensor ops here. The head
  contracts the local h-slice and psums the logits; the lookahead is
  depthwise over H and runs on the slice.

The conv stack is replicated. Every rank returns the whole (N, T', C)
probabilities. Only GRU models are covered, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..models import deepspeech as ds
from ..ops import conv as conv_ops
from ..ops import gru_cuda
from ..ops.rnn import GRUWeights
from .mesh import MODEL_AXIS, Mesh, all_gather, axis_index, psum

# ---------------------------------------------------------------------------
# Gate-aligned packing
# ---------------------------------------------------------------------------


def _permute_gate_cols(w: torch.Tensor, n: int, gates: int = 3) -> torch.Tensor:
    """Reorder a (..., gates*H) tensor's last dim from gate-major [r|z|n] to
    shard-major [r_0|z_0|n_0|r_1|z_1|n_1|...]."""
    h = w.shape[-1] // gates
    if h % n:
        raise ValueError(f"hidden size {h} not divisible by {n} TP shards")
    hs = h // n
    parts = w.reshape(*w.shape[:-1], gates, n, hs).transpose(-3, -2)
    return parts.reshape(*w.shape[:-1], gates * h).contiguous()


def _pack_dir(wts: GRUWeights, n: int) -> GRUWeights:
    return GRUWeights(*(_permute_gate_cols(t, n) for t in wts))


def pack_tp_params(params, n: int):
    """Every RNN layer's gate-stacked columns in shard-grouped order for an
    n-way model axis; conv, BatchNorm, lookahead and head stay as they are.
    Pack exactly once."""
    packed = dict(params)
    packed["rnns"] = [
        {
            "bn": e["bn"],
            "fwd": _pack_dir(e["fwd"], n),
            "bwd": _pack_dir(e["bwd"], n) if e["bwd"] is not None else None,
        }
        for e in params["rnns"]
    ]
    return packed


def resolve_mode(config, n: int, mode: str) -> str:
    """``"auto"`` is direction for a bidirectional model on a 2-way axis,
    else hidden."""
    if mode == "auto":
        return "direction" if (config.bidirectional and n == 2) else "hidden"
    if mode not in ("direction", "hidden"):
        raise ValueError(f"unknown TP mode {mode!r}")
    return mode


# ---------------------------------------------------------------------------
# The recurrences
# ---------------------------------------------------------------------------


def _bn(entry, x):
    if entry["bn"] is None:
        return x
    scale, shift = entry["bn"].scale_shift()
    return x * scale + shift


def _gru_layer_dirsharded(x, lengths, entry, mesh: Mesh, axis: str):
    """Direction parallelism: this rank's chain as one ``gru_scan`` launch
    on its direction's full weights; the sum merge is one psum."""
    reverse = axis_index(mesh, axis) == 1
    w = entry["bwd"] if reverse else entry["fwd"]
    gx = torch.matmul(x.to(w.w_ih.dtype), w.w_ih).contiguous()
    h0 = torch.zeros((x.shape[1], w.w_hh.shape[0]), dtype=torch.float32, device=x.device)
    out, _ = gru_cuda.gru_scan(gx, lengths, w.w_hh, w.b_ih.float(), w.b_hh.float(),
                               h0, reverse)
    return psum(out.float(), mesh, axis)


def _gru_layer_hsharded(x, lengths, entry, mesh: Mesh, axis: str):
    """Gate-aligned hidden sharding: (T, B, I) whole -> (T, B, H) whole.
    Each step: whole h times the local (H, 3h) columns, gate math on the
    h-slice, one all_gather of (D, B, h) reassembles h. The backward chain
    walks time in reverse and holds its state until t < length."""
    n, k = mesh.size(axis), axis_index(mesh, axis)
    dirs = [entry["fwd"]] if entry["bwd"] is None else [entry["fwd"], entry["bwd"]]
    hidden = dirs[0].w_hh.shape[0]
    hloc = hidden // n
    cols = slice(3 * hloc * k, 3 * hloc * (k + 1))
    t_max, batch, _ = x.shape
    mm_dtype = dirs[0].w_ih.dtype
    dev = x.device
    x_mm = x.to(mm_dtype).float()
    gx = torch.stack([x_mm @ d.w_ih[:, cols].float() + d.b_ih[cols].float()
                      for d in dirs])  # (D, T, B, 3h) f32
    w_hh = torch.stack([d.w_hh[:, cols].float() for d in dirs])  # (D, H, 3h)
    b_hh = torch.stack([d.b_hh[cols].float() for d in dirs])[:, None, :]
    lengths = lengths.to(dev).long()
    h = torch.zeros((len(dirs), batch, hidden), dtype=torch.float32, device=dev)
    out = torch.zeros((len(dirs), t_max, batch, hloc), dtype=torch.float32, device=dev)
    hs = slice(k * hloc, (k + 1) * hloc)
    for s in range(t_max):
        ts = [s, t_max - 1 - s][: len(dirs)]
        gx_t = torch.stack([gx[d, t] for d, t in enumerate(ts)])  # (D, B, 3h)
        gh = torch.bmm(h.to(mm_dtype).float(), w_hh) + b_hh
        r = torch.sigmoid(gx_t[..., :hloc] + gh[..., :hloc])
        z = torch.sigmoid(gx_t[..., hloc : 2 * hloc] + gh[..., hloc : 2 * hloc])
        nn_ = torch.tanh(gx_t[..., 2 * hloc :] + r * gh[..., 2 * hloc :])
        h_new_loc = (1.0 - z) * nn_ + z * h[..., hs]
        h_new = all_gather(h_new_loc, mesh, axis, dim=2)  # the one exchange
        valid = torch.stack([(lengths > t) for t in ts])[..., None]  # (D, B, 1)
        h = torch.where(valid, h_new, h)
        for d, t in enumerate(ts):
            out[d, t] = torch.where(valid[d], h_new_loc[d], 0.0)
    merged = out.sum(dim=0)  # directions summed, (T, B, h)
    return all_gather(merged, mesh, axis, dim=2)


@torch.inference_mode()
def tp_forward(params, config, x: torch.Tensor, input_lengths: torch.Tensor,
               mesh: Mesh, axis: str = MODEL_AXIS, mode: str = "auto"):
    """Tensor-parallel forward: (N, 1, F, T) -> ((N, T', C) probs,
    out_lengths), the whole of both on every rank of ``axis``.

    ``params`` are whole trees on the mesh's device, packed with
    :func:`pack_tp_params` for hidden mode (direction mode takes the natural
    layout). ``mode`` is "direction", "hidden" or "auto"
    (:func:`resolve_mode`).
    """
    n = mesh.size(axis)
    mode = resolve_mode(config, n, mode)
    if mode == "direction" and (not config.bidirectional or n != 2):
        raise ValueError("direction mode needs a bidirectional model on a 2-way axis")
    if config.rnn_type != "gru":
        raise NotImplementedError("TP forward covers the GRU zoo models")

    x = x.to(mesh.device)
    out_lengths = ds.get_seq_lens(config, torch.as_tensor(input_lengths).to(mesh.device))
    x = ds.conv_stack(params, config, x, out_lengths)
    nb, c, f, t = x.shape
    x = x.reshape(nb, c * f, t).permute(2, 0, 1).float()  # (T, B, H)
    lengths = out_lengths.to(torch.int32).contiguous()
    layer = _gru_layer_dirsharded if mode == "direction" else _gru_layer_hsharded
    for entry in params["rnns"]:
        x = layer(_bn(entry, x), lengths, entry, mesh, axis)

    if mode == "direction":
        logits = ds.head(params, x)
    else:
        k, hloc = axis_index(mesh, axis), config.rnn_hidden_size // n
        hs = slice(k * hloc, (k + 1) * hloc)
        if not config.bidirectional:
            # depthwise over H: the lookahead runs on the local rows
            la = params["lookahead"]._replace(weight=params["lookahead"].weight[hs])
            x_la = conv_ops.hardtanh(conv_ops.lookahead(x[..., hs], la))
            x = all_gather(x_la, mesh, axis, dim=2)
        # contract the local h-slice, psum the class logits
        scale, shift = params["fc_bn"].scale_shift()
        x_loc = x[..., hs] * scale[hs] + shift[hs]
        w = params["fc"].weight[:, hs]
        logits = psum(x_loc.to(w.dtype).float() @ w.float().T, mesh, axis)
    probs = torch.softmax(logits.permute(1, 0, 2), dim=-1)
    return probs, out_lengths
