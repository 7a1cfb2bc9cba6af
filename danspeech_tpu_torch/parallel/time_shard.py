"""Sequence parallelism: one long utterance's time axis sharded over the
ranks of a mesh axis.

The port of ``danspeech_tpu/parallel/time_shard.py``. Rank ``c`` of ``n``
holds the ``c``-th of ``n`` equal chunks of the spectrogram's time axis, and

- the **conv stack** runs on every chunk at once, each block after a halo
  exchange of its kernel's time context with the ring neighbours
  (:func:`ppermute`; the boundary ranks receive zeros, which are the global
  zero padding), convolving VALID in time;
- the **unidirectional GRU stack** runs as a wavefront over (layer, chunk):
  at global step ``s`` rank ``c`` runs layer ``s - c`` on its chunk, one
  ``gru_scan`` launch from the ``h0`` that rank ``c - 1`` handed over at step
  ``s - 1``, and hands its own last state on; ``L + n - 1`` steps in all.
  The JAX loop computes some layer on every rank at every step and keeps the
  active one; only the active layer is launched here, with the same result;
- the **bidirectional GRU stack** runs layer by layer as a two-direction
  ring: both directions' input projections run on every chunk at once, then
  rank ``c`` runs the forward chain at ring step ``c`` and the backward
  chain at step ``n - 1 - c``. A step with one chain launches ``gru_scan``
  (``reverse=True`` for the backward chain, which walks its chunk from the
  end and holds the received ``h`` through the chunk's invalid tail); a step
  with both (world size 1, and the middle rank when ``n`` is odd) launches
  ``gru_scan_bidi`` with both carried states;
- the **lookahead** of unidirectional models reads the next ranks' first
  frames, over as many hops as its context needs.

Each rank's valid frames are a prefix of its chunk (the global length
clipped to the chunk), so the kernels' rule that a row freezes past its
length gives the frozen-state handoff of the JAX scan's mask. The result is
gathered over the axis, so every rank returns the whole ``(B, T', C)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import deepspeech as ds
from ..models.config import CONV_SPECS, DeepSpeechConfig
from ..ops import conv as conv_ops
from ..ops import gru_cuda
from ..ops import stft as stft_ops
from .mesh import DATA_AXIS, Mesh, all_gather, axis_index, ppermute

# ---------------------------------------------------------------------------
# Halo exchange and the conv stack
# ---------------------------------------------------------------------------


def halo_exchange(x: torch.Tensor, halo: int, mesh: Mesh, axis: str) -> torch.Tensor:
    """Concatenate the neighbours' context onto the (last) time axis: the
    previous rank's last ``halo`` columns before, the next rank's first
    ``halo`` after; the first and last ranks receive zeros."""
    if halo > x.shape[-1]:
        raise ValueError(
            f"conv halo {halo} exceeds local chunk {x.shape[-1]}; use fewer "
            "time shards for this utterance length"
        )
    left = ppermute(x[..., -halo:], mesh, axis, +1)
    right = ppermute(x[..., :halo], mesh, axis, -1)
    return torch.cat([left, x, right], dim=-1)


def _conv_block_halo(x, p, spec, lengths, t_offset, mesh, axis):
    """One masked conv block over a time chunk: the halo of ``pad_t``
    columns, then a convolution VALID in time and padded in frequency.
    Output time length is ``T_local // stride_t``."""
    pf, pt = spec["padding"]
    x = halo_exchange(x, pt, mesh, axis)
    w, b = conv_ops.fold_bn_into_conv(p)
    out = conv_ops.hardtanh(conv_ops.conv2d(x, w, b, spec["stride"], (pf, 0)))
    t_global = t_offset + torch.arange(out.shape[-1], device=out.device)
    mask = (t_global[None, :] < lengths.to(out.device)[:, None]).to(out.dtype)
    return out * mask[:, None, None, :]


def conv_stack_time_sharded(params, config, x_local, out_lengths, mesh, axis):
    """Masked conv stack on a local (B, 1, F, T/n) chunk -> (B, C, F', T'/n).
    ``out_lengths`` are the global post-stack frame counts; each rank masks
    from its global frame offset ``c * T_local / 2``."""
    t_offset = axis_index(mesh, axis) * (x_local.shape[-1] // 2)
    for p, spec in zip(params["conv"], CONV_SPECS[: config.conv_layers]):
        x_local = _conv_block_halo(x_local, p, spec, out_lengths, t_offset, mesh, axis)
    return x_local


# ---------------------------------------------------------------------------
# The GRU stack over the ring
# ---------------------------------------------------------------------------


def _bn(entry, x):
    if entry["bn"] is None:
        return x
    scale, shift = entry["bn"].scale_shift()
    return x * scale + shift


def _project(x, w):
    """The bias-free input projection in the weights' dtype (b_ih is added
    in the kernel)."""
    return torch.matmul(x.to(w.w_ih.dtype), w.w_ih).contiguous()


def _chain(gx, lengths, w, h0, reverse: bool):
    """One ``gru_scan`` over the chunk from ``h0``."""
    out, h_last = gru_cuda.gru_scan(gx, lengths, w.w_hh, w.b_ih.float(),
                                    w.b_hh.float(), h0.contiguous(), reverse)
    return out.float(), h_last


def gru_stack_wavefront(params, config, x_local, local_lengths, mesh, axis):
    """Unidirectional stacked GRU as a (layer x chunk) wavefront over
    (T_local, B, I) -> (T_local, B, H)."""
    hidden = config.rnn_hidden_size
    n_layers = config.rnn_layers
    n, c = mesh.size(axis), axis_index(mesh, axis)
    batch = x_local.shape[1]
    zeros = torch.zeros((batch, hidden), dtype=torch.float32, device=x_local.device)
    x, h_in = x_local.float(), zeros
    for s in range(n_layers + n - 1):
        layer = s - c
        h_last = zeros
        if 0 <= layer < n_layers:
            entry = params["rnns"][layer]
            w = entry["fwd"]
            x, h_last = _chain(_project(_bn(entry, x), w), local_lengths, w, h_in, False)
        # rank c + 1 runs this layer at step s + 1 from h_last; rank 0
        # receives zeros, the sequence's initial state
        h_in = ppermute(h_last, mesh, axis, +1)
    return x


def gru_stack_ring_bidi(params, config, x_local, local_lengths, mesh, axis):
    """Bidirectional stacked GRU over a two-direction ring, layer by layer,
    (T_local, B, I) -> (T_local, B, H), directions summed."""
    hidden = config.rnn_hidden_size
    n, c = mesh.size(axis), axis_index(mesh, axis)
    batch = x_local.shape[1]
    zeros = torch.zeros((batch, hidden), dtype=torch.float32, device=x_local.device)
    x = x_local.float()
    for entry in params["rnns"]:
        x = _bn(entry, x)
        fw, bw = entry["fwd"], entry["bwd"]
        gx_f, gx_b = _project(x, fw), _project(x, bw)
        h_f = h_b = zeros
        out_f = out_b = None
        for k in range(n):
            run_f, run_b = k == c, k == n - 1 - c
            hl_f = hl_b = zeros
            if run_f and run_b:
                out_f, out_b, hl_f, hl_b = gru_cuda.gru_scan_bidi(
                    gx_f, gx_b, local_lengths, fw.w_hh, bw.w_hh,
                    fw.b_ih.float(), bw.b_ih.float(), fw.b_hh.float(), bw.b_hh.float(),
                    h_f.contiguous(), h_b.contiguous(),
                )
                out_f, out_b = out_f.float(), out_b.float()
            elif run_f:
                out_f, hl_f = _chain(gx_f, local_lengths, fw, h_f, False)
            elif run_b:
                out_b, hl_b = _chain(gx_b, local_lengths, bw, h_b, True)
            h_f = ppermute(hl_f, mesh, axis, +1)
            h_b = ppermute(hl_b, mesh, axis, -1)
        x = out_f + out_b  # the sum merge
    return x


def lookahead_time_sharded(x_local, p, mesh, axis):
    """Lookahead conv over future context on (T_local, B, H): the next
    ranks' first frames, over as many hops as the context needs (the last
    rank's missing future frames are zeros, the right padding)."""
    t_local = x_local.shape[0]
    context = p.weight.shape[1]
    parts, src, needed = [x_local.float()], x_local.float(), context - 1
    while needed > 0:
        src = ppermute(src, mesh, axis, -1)
        take = min(t_local, needed)
        parts.append(src[:take])
        needed -= take
    x_ext = torch.cat(parts, dim=0)
    stacked = torch.stack([x_ext[k : k + t_local] for k in range(context)])
    return torch.einsum("ctbh,hc->tbh", stacked, p.weight.float())


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------


def _forward_local(params, config, x_local, input_lengths, mesh, axis):
    """This rank's spectrogram chunk -> its chunk of the probabilities."""
    out_lengths = ds.get_seq_lens(config, input_lengths)
    x = conv_stack_time_sharded(params, config, x_local, out_lengths, mesh, axis)
    b, ch, f, t = x.shape
    x = x.reshape(b, ch * f, t).permute(2, 0, 1)  # (T_local, B, H)
    offset = axis_index(mesh, axis) * t
    local_lengths = (out_lengths.to(x.device).long() - offset).clamp(0, t)
    local_lengths = local_lengths.to(torch.int32).contiguous()
    if config.bidirectional:
        x = gru_stack_ring_bidi(params, config, x, local_lengths, mesh, axis)
    else:
        x = gru_stack_wavefront(params, config, x, local_lengths, mesh, axis)
        x = conv_ops.hardtanh(lookahead_time_sharded(x, params["lookahead"], mesh, axis))
    x = ds.head(params, x).permute(1, 0, 2)  # (B, T_local, C)
    return torch.softmax(x, dim=-1), out_lengths


def _check(config: DeepSpeechConfig):
    if config.rnn_type != "gru":
        raise NotImplementedError(
            "the time-sharded forward covers GRU models, as in the JAX package")


@torch.inference_mode()
def time_sharded_forward(params, config: DeepSpeechConfig, spect: torch.Tensor,
                         input_lengths: torch.Tensor, mesh: Mesh,
                         axis: str = DATA_AXIS):
    """The acoustic model with the time axis sharded over ``mesh``'s
    ``axis``.

    ``spect`` is the whole (B, 1, F, T) spectrogram, the same on every rank,
    with T divisible by 2 * n (:func:`pad_time_for_mesh`); ``params`` are on
    the mesh's device. Each rank computes its chunk; returns (probs
    (B, T', C), out_lengths (B,)), the whole of both on every rank, as
    ``forward`` returns them.
    """
    _check(config)
    n = mesh.size(axis)
    if spect.shape[-1] % (2 * n):
        raise ValueError(f"time length {spect.shape[-1]} must be divisible by 2*{n}")
    t_local = spect.shape[-1] // n
    c = axis_index(mesh, axis)
    x_local = spect[..., c * t_local : (c + 1) * t_local].to(mesh.device).float()
    lengths = torch.as_tensor(input_lengths).to(mesh.device)
    probs, out_lengths = _forward_local(params, config, x_local, lengths, mesh, axis)
    return all_gather(probs.float().contiguous(), mesh, axis, dim=1), out_lengths


def pad_time_for_mesh(spect, n: int):
    """Zero-pad (B, 1, F, T) on T up to a multiple of 2n (conv1 stride x n
    chunks); the padding is masked by the global length downstream.
    Takes and returns a numpy array or a tensor."""
    t = spect.shape[-1]
    t_pad = -(-t // (2 * n)) * (2 * n)
    if t_pad == t:
        return spect
    if isinstance(spect, torch.Tensor):
        return torch.nn.functional.pad(spect, (0, t_pad - t))
    return np.pad(spect, ((0, 0), (0, 0), (0, 0), (0, t_pad - t)))


def long_form_probs(model, waveform, mesh: Mesh, params=None, axis: str = DATA_AXIS):
    """One waveform -> (probs (1, T', C), out_lengths (1,)) through the
    time-sharded forward. ``params`` default to the model's, cast and placed
    as the port serves them on the mesh's device."""
    from ..features.spectrogram import SpectrogramAudioParser
    from .batch import device_params

    _check(model.config)
    if params is None:
        params = device_params(model.params, mesh.device)
    parser = SpectrogramAudioParser(model.audio_conf)
    wav = torch.as_tensor(np.asarray(waveform)).to(mesh.device).float()
    spect, frame_len = stft_ops.batched_log_spectrogram(
        wav[None, :], torch.tensor([wav.shape[0]], device=mesh.device),
        parser.n_fft, parser.hop_length, parser.window.to(mesh.device),
        normalize=parser.normalize,
    )
    spect = pad_time_for_mesh(spect[:, None], mesh.size(axis))
    return time_sharded_forward(params, model.config, spect, frame_len, mesh, axis)


def transcribe_long_form(model, waveform: np.ndarray, mesh: Mesh, decoder=None,
                         params=None) -> str:
    """Transcribe one long utterance with its time axis sharded over the
    mesh's data axis: spectrogram on the rank's device, the time-sharded
    forward, then ``decoder`` (greedy by default)."""
    from ..decode.greedy import GreedyDecoder

    probs, out_lens = long_form_probs(model, waveform, mesh, params)
    decoder = decoder or GreedyDecoder(model.labels)
    decoded, _ = decoder.decode(probs.cpu().numpy(), out_lens.cpu().numpy())
    return decoded[0][0]
