"""Float32 on the card (the recurrent kernels' float32 variants: B1-B4 in
csrc/gru_f32.cu, B5-B7 in csrc/lstm_f32.cu, B8-B9 in csrc/rnn_tanh_f32.cu),
what can be checked without one (CPU).

- what each float32 route hands its C entry: the numbers of pointers and ints
  bound against the ``extern "C"`` signature parsed from the source, and the
  ints passed (recorded on CPU tensors, no launch);
- the full-float32 scope (``ops/precision.py``) turns TF32 off inside and
  puts the caller's settings back, nested and after an exception;
- a float32 engine on CUDA loads an LSTM or tanh-RNN model as it does a GRU
  one, its weights float32;
- in float32 neither C5 (a bf16 convolution rounds its output), C10 (the
  dW / dx products round to bf16 on CUDA) nor C12 (the bf16 projection is
  rounded before its bias is added) arises: nothing is rounded to bf16, and
  the port's float32 convolution and GRU, LSTM and tanh-RNN gradients meet
  the JAX package's within float32 summation order (CONV_ATOL, GRAD_TOL).

The kernels themselves run only on the card: ``chip_smoke.py`` phase 12
(``--only 12``) holds each float32 entry against its plain version there.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from danspeech_tpu.models.config import CONV_SPECS
from danspeech_tpu.ops import conv as jconv
from danspeech_tpu.ops import rnn as jrnn
from danspeech_tpu_torch.engine import DanSpeechRecognizer as TEngine
from danspeech_tpu_torch.models import DeepSpeechModel as TModel
from danspeech_tpu_torch.models import deepspeech as tds
from danspeech_tpu_torch.models.config import DeepSpeechConfig as TConfig
from danspeech_tpu_torch.ops import conv as tconv
from danspeech_tpu_torch.ops import cuda_build, gru_cuda, lstm_cuda, precision, rnn_tanh_cuda
from danspeech_tpu_torch.ops import rnn as trnn

CONV_ATOL = 1e-4   # float32 sums of up to 7392 terms in another order
GRAD_TOL = 2e-4    # the bound of the JAX package's own float32 gradient test


# ---------------------------------------------------------------------------
# What the float32 routes hand their C entries
# ---------------------------------------------------------------------------


def _c_signature(fn_name, source="gru_f32"):
    """(pointer parameters, int parameters) of ``extern "C" int fn_name(...)``
    in csrc/<source>.cu, the trailing stream left out; the pointers must all
    come before the ints."""
    with open(os.path.join(cuda_build.CSRC_DIR, f"{source}.cu")) as f:
        text = re.sub(r"//[^\n]*", "", f.read())
    m = re.search(r'extern "C" int ' + fn_name + r"\((.*?)\)\s*\{", text, re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    assert params[-1] == "void* stream"
    kinds = ["ptr" if "*" in p else "int" for p in params[:-1]]
    assert all(p.startswith("int ") for p, k in zip(params, kinds) if k == "int")
    assert kinds == sorted(kinds, key=lambda k: k != "ptr"), "pointers first, then ints"
    return kinds.count("ptr"), kinds.count("int")


class _Recorder:
    """Stands in for cuda_build.bind and cuda_build.call: records what a
    route binds and the arguments it would launch with."""

    def __init__(self, monkeypatch):
        self.bound, self.calls = [], []
        monkeypatch.setattr(cuda_build, "bind", lambda *a: self.bound.append(a) or a)
        monkeypatch.setattr(cuda_build, "call",
                            lambda fn, name, dev, *args: self.calls.append((fn, args)))

    def only_call(self, want_source="gru_f32"):
        (source, fn_name, n_ptr, n_int), = self.bound
        assert source == want_source
        assert (n_ptr, n_int) == _c_signature(fn_name, source)
        (_, args), = self.calls
        assert len(args) == n_ptr + n_int
        return args[:n_ptr], list(args[n_ptr:])


def _f32(*shape):
    return torch.randn(*shape)


T, B, H, D = 6, 3, 16, 10
LENGTHS = torch.tensor([6, 2, 0], dtype=torch.int32)


def _scan_chain(h0=None):
    return (_f32(T, B, 3 * H), LENGTHS, _f32(H, 3 * H), _f32(3 * H), _f32(3 * H),
            _f32(B, H) if h0 is None else h0)


def _walk_chain():
    return (_f32(T, B, 3 * H), _f32(T, B, H), _f32(T, B, H), LENGTHS, _f32(H, 3 * H),
            _f32(3 * H), _f32(3 * H), _f32(B, H))


@pytest.mark.parametrize("chains,reverses", [(1, [False]), (1, [True]), (2, [False, True])])
def test_scan_route_matches_its_c_entry(monkeypatch, chains, reverses):
    """B1 (one chain) and B2 (both chains of a layer, the second in reverse
    time): the entry gets each chain's pointers (one chain fills both), the
    h0s in buffer 0 of the state, and (T, B, H, reverse_a, reverse_b,
    chains)."""
    rec = _Recorder(monkeypatch)
    ops = [_scan_chain() for _ in range(chains)]
    outs = gru_cuda._scan_f32(ops, reverses)
    ptrs, ints = rec.only_call()
    assert ints == [T, B, H, int(reverses[0]), int(reverses[-1]), chains]
    assert ptrs[0] == ops[0][0].data_ptr() and ptrs[1] == ops[-1][0].data_ptr()
    assert ptrs[2] == LENGTHS.data_ptr()
    assert [(tuple(o.shape), o.dtype) for o in outs[-1]] == \
        [((T, B, H), torch.float32), ((B, H), torch.float32)]
    # the state the entry reads first holds each chain's h0
    h32 = torch.stack([o[1] for o in outs])  # views of buffer T % 2 = 0
    for k, c in enumerate(ops):
        assert torch.equal(h32[k], c[5])


def test_bidi_fused_route_matches_its_c_entry(monkeypatch):
    rec = _Recorder(monkeypatch)
    x = _f32(T, B, D)
    w = (_f32(D, 3 * H), _f32(D, 3 * H), _f32(H, 3 * H), _f32(H, 3 * H),
         _f32(3 * H), _f32(3 * H), _f32(3 * H), _f32(3 * H))
    out_f, out_b, hl_f, hl_b = gru_cuda._bidi_fused_f32(x, LENGTHS, *w)
    ptrs, ints = rec.only_call()
    assert ints == [T, B, D, H]
    assert list(ptrs[:10]) == [x.data_ptr(), LENGTHS.data_ptr(), *(t.data_ptr() for t in w)]
    assert {tuple(o.shape) for o in (out_f, out_b)} == {(T, B, H)}
    assert {tuple(h.shape) for h in (hl_f, hl_b)} == {(B, H)}
    assert not hl_f.any() and not hl_b.any()  # h0 = 0


@pytest.mark.parametrize("chains,reverses", [(1, [True]), (1, [False]), (2, [True, False])])
def test_bwd_route_matches_its_c_entry(monkeypatch, chains, reverses):
    """B4, one walk or the pair of a bidirectional layer: each chain's
    streams and weights, dh_last in buffer 0 of the carry, zeros in buffer 0
    of dgh, and (T, B, H, reverse_a, reverse_b, chains)."""
    rec = _Recorder(monkeypatch)
    ops = [_walk_chain() for _ in range(chains)]
    outs = gru_cuda._bwd_f32(ops, reverses)
    ptrs, ints = rec.only_call()
    assert ints == [T, B, H, int(reverses[0]), int(reverses[-1]), chains]
    assert ptrs[6] == LENGTHS.data_ptr()
    assert ptrs[7] == ops[0][4].data_ptr() and ptrs[8] == ops[-1][4].data_ptr()
    assert [(tuple(o.shape), o.dtype) for o in outs[-1]] == [
        ((T, B, 3 * H), torch.float32), ((T, B, H), torch.float32), ((B, H), torch.float32)]
    part, dgx_a = ptrs[13], ptrs[15]
    assert dgx_a == outs[0][0].data_ptr()
    # dh0 is read from buffer (T + 1) % 2 of the carry, the one the entry's
    # last step writes
    for k, (_, _, dh0) in enumerate(outs):
        assert dh0.data_ptr() == part + (((T + 1) % 2) * chains + k) * B * H * 4


def _lstm_chain():
    return (_f32(T, B, 4 * H), LENGTHS, _f32(H, 4 * H), _f32(4 * H), _f32(B, H), _f32(B, H))


def _lstm_walk():
    return (_f32(T, B, 4 * H), _f32(T, B, H), _f32(T, B, H), _f32(T, B, H), LENGTHS,
            _f32(H, 4 * H), _f32(4 * H))


def _pairs(ptrs, first, tensors):
    """The two per-chain pointers at ``first`` are the first and the last
    chain's tensors (one chain fills both)."""
    first %= len(ptrs)
    return list(ptrs[first:first + 2]) == [tensors[0].data_ptr(), tensors[-1].data_ptr()]


@pytest.mark.parametrize("with_cell", [False, True])
@pytest.mark.parametrize("chains,reverses", [(1, [False]), (1, [True]), (2, [False, True])])
def test_lstm_scan_route_matches_its_c_entry(monkeypatch, chains, reverses, with_cell):
    """B5 and B6, one chain or both chains of a layer in each step launch:
    each chain's gx, w_hh and b_hh, the h0s in buffer 0 of the state, the
    c0s in the cell buffer the entry updates in place (c_last views it), the
    cell streams' pointers set only for B6, and (T, B, H, reverse_a,
    reverse_b, chains)."""
    rec = _Recorder(monkeypatch)
    ops = [_lstm_chain() for _ in range(chains)]
    outs = lstm_cuda._scan_f32(ops, reverses, with_cell)
    ptrs, ints = rec.only_call("lstm_f32")
    assert ints == [T, B, H, int(reverses[0]), int(reverses[-1]), chains]
    assert _pairs(ptrs, 0, [c[0] for c in ops]) and ptrs[2] == LENGTHS.data_ptr()
    assert _pairs(ptrs, 3, [c[2] for c in ops]) and _pairs(ptrs, 5, [c[3] for c in ops])
    assert _pairs(ptrs, 9, [o[0] for o in outs])
    if with_cell:
        assert _pairs(ptrs, 11, [o[1] for o in outs])
    else:
        assert ptrs[11] is None and ptrs[12] is None
    streams = 2 if with_cell else 1
    assert [(tuple(o.shape), o.dtype) for o in outs[-1]] == \
        [((T, B, H), torch.float32)] * streams + [((B, H), torch.float32)] * 2
    for k, c in enumerate(ops):
        h_last, c_last = outs[k][-2:]
        # T is even: the state the entry reads first is the one it ends in
        assert h_last.data_ptr() == ptrs[7] + k * B * H * 4 and torch.equal(h_last, c[4])
        assert c_last.data_ptr() == ptrs[8] + k * B * H * 4 and torch.equal(c_last, c[5])


@pytest.mark.parametrize("chains,reverses", [(1, [True]), (1, [False]), (2, [True, False])])
def test_lstm_bwd_route_matches_its_c_entry(monkeypatch, chains, reverses):
    """B7, one walk or the pair of a layer in each step launch: each chain's
    gx, hprev, cprev, dout, w_hh and b_hh, the dh and dc carries zeroed (dh0
    and dc0 view them), each chain's dg4 buffer, and (T, B, H, reverse_a,
    reverse_b, chains)."""
    rec = _Recorder(monkeypatch)
    ops = [_lstm_walk() for _ in range(chains)]
    outs = lstm_cuda._bwd_f32(ops, reverses)
    ptrs, ints = rec.only_call("lstm_f32")
    assert ints == [T, B, H, int(reverses[0]), int(reverses[-1]), chains]
    for i in range(4):  # gx, hprev, cprev, dout
        assert _pairs(ptrs, 2 * i, [c[i] for c in ops])
    assert ptrs[8] == LENGTHS.data_ptr()
    assert _pairs(ptrs, 9, [c[5] for c in ops]) and _pairs(ptrs, 11, [c[6] for c in ops])
    assert _pairs(ptrs, 15, [o[0] for o in outs])
    for k, (dg4, dh0, dc0) in enumerate(outs):
        assert (tuple(dg4.shape), dg4.dtype) == ((T, B, 4 * H), torch.float32)
        assert dh0.data_ptr() == ptrs[13] + k * B * H * 4 and not dh0.any()
        assert dc0.data_ptr() == ptrs[14] + k * B * H * 4 and not dc0.any()


@pytest.mark.parametrize("walk", [False, True])
@pytest.mark.parametrize("chains,reverses", [(1, [False]), (1, [True]), (2, [False, True])])
def test_tanh_routes_match_their_c_entries(monkeypatch, chains, reverses, walk):
    """B8 (h0 = 0 in buffer 0 of the state) and B9 (the dh carry zeroed, dh0
    views it), one chain or both chains of a layer in each step launch: each
    chain's streams and w_hh, and (T, B, H, reverse_a, reverse_b, chains)."""
    rec = _Recorder(monkeypatch)
    if walk:
        ops = [(_f32(T, B, H), _f32(T, B, H), LENGTHS, _f32(H, H)) for _ in range(chains)]
        outs = rnn_tanh_cuda._bwd_f32(ops, reverses)
    else:
        ops = [(_f32(T, B, H), LENGTHS, _f32(H, H)) for _ in range(chains)]
        outs = rnn_tanh_cuda._scan_f32(ops, reverses)
    ptrs, ints = rec.only_call("rnn_tanh_f32")
    assert ints == [T, B, H, int(reverses[0]), int(reverses[-1]), chains]
    assert _pairs(ptrs, 0, [c[0] for c in ops]) and _pairs(ptrs, -2, [o[0] for o in outs])
    seq, state = (4, 7) if walk else (2, 5)  # lengths, then the carried state
    if walk:
        assert _pairs(ptrs, 2, [c[1] for c in ops])
    assert ptrs[seq] == LENGTHS.data_ptr() and _pairs(ptrs, seq + 1, [c[-1] for c in ops])
    for k, (stream, last) in enumerate(outs):
        assert (tuple(stream.shape), stream.dtype) == ((T, B, H), torch.float32)
        assert last.data_ptr() == ptrs[state] + k * B * H * 4 and not last.any()


# ---------------------------------------------------------------------------
# The full-float32 scope
# ---------------------------------------------------------------------------


@pytest.fixture
def tf32_allowed():
    """A caller that allowed TF32 for products and convolutions; its
    settings come back after the test."""
    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.set_float32_matmul_precision(saved[0])
    torch.backends.cudnn.allow_tf32 = saved[1]


def _flags():
    return torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32


def test_scope_turns_tf32_off_and_restores_the_callers_flags(tf32_allowed):
    with precision.full_float32("cuda"):
        assert _flags() == ("highest", False)
        with precision.full_float32(torch.device("cuda", 0)):  # nested
            assert _flags() == ("highest", False)
        assert _flags() == ("highest", False)  # the outer scope still holds
    assert _flags() == ("high", True)
    with pytest.raises(RuntimeError, match="inside"):
        with precision.full_float32("cuda"):
            raise RuntimeError("inside")
    assert _flags() == ("high", True)


@pytest.mark.parametrize("device,enabled", [("cpu", True), ("cuda", False), ("meta", True)])
def test_scope_is_a_no_op_off_cuda_or_when_not_enabled(tf32_allowed, device, enabled):
    """bf16 serving and mixed precision never enter it; nor does the CPU."""
    with precision.full_float32(device, enabled):
        assert _flags() == ("high", True)
    assert _flags() == ("high", True)


# ---------------------------------------------------------------------------
# LSTM and tanh-RNN models in float32 on CUDA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rnn_type", ["lstm", "rnn"])
def test_float32_lstm_and_tanh_models_are_refused_when_loaded(rnn_type, monkeypatch):
    """A float32 engine on CUDA takes an LSTM or tanh-RNN model as it does a
    GRU one (B5-B9 have float32 variants): ``update_model``'s parameters for
    the device hold every recurrent weight in float32 (the move to the
    device is recorded, no card needed)."""
    moved = []
    monkeypatch.setattr(tds, "params_to", lambda params, dev: moved.append(dev) or params)
    eng = TEngine(device="cpu", compute_dtype="float32")
    eng.device = torch.device("cuda")  # as a float32 engine on the card holds it
    cfg = TConfig(model_name="x", rnn_type=rnn_type, rnn_hidden_size=8, rnn_layers=1,
                  conv_layers=1)
    model = TModel.init_random(cfg, seed=0)
    params = eng._device_params(model)
    assert moved == [torch.device("cuda")]
    for entry in params["rnns"]:
        for w in (entry["fwd"], entry["bwd"]):
            assert w.w_ih.dtype == w.w_hh.dtype == torch.float32


# ---------------------------------------------------------------------------
# C5, C10 and C12 do not arise in float32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_float32_conv_block_keeps_float32_c5(layer):
    """C5: a bf16 convolution rounds its output to bf16 where the JAX one
    keeps float32. In float32 mode the weights stay float32, no output is
    rounded, and the two meet within CONV_ATOL (summation order)."""
    rng = np.random.default_rng(40 + layer)
    spec = CONV_SPECS[layer]
    kf, kt = spec["kernel"]
    bound = 1.0 / np.sqrt(spec["in"] * kf * kt)
    arrays = [rng.uniform(-bound, bound, (spec["out"], spec["in"], kf, kt)),
              rng.uniform(-bound, bound, spec["out"]), rng.normal(1.0, 0.2, spec["out"]),
              rng.normal(0.0, 0.2, spec["out"]), rng.normal(0.0, 0.5, spec["out"]),
              rng.uniform(0.5, 2.0, spec["out"])]
    arrays = [a.astype(np.float32) for a in arrays]
    x = rng.normal(size=(2, spec["in"], 161, 41)).astype(np.float32)
    if layer:
        x = np.clip(x * 5.0, 0.0, 20.0)
    lengths = np.array([41, 17], np.int32)
    st, pd = spec["stride"], spec["padding"]
    out_len = tconv.conv_out_length(lengths, kt, st[1], pd[1])
    ref = jconv.conv_block(jnp.asarray(x), jconv.ConvParams(*map(jnp.asarray, arrays)),
                           jnp.asarray(out_len), st, pd)
    got = tconv.conv_block(torch.from_numpy(x),
                           tconv.ConvParams(*map(torch.from_numpy, arrays)),
                           torch.from_numpy(out_len), st, pd)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=CONV_ATOL, rtol=0)


@pytest.mark.parametrize("bidi", [True, False])
def test_float32_gru_gradients_keep_float32_c10(bidi):
    """C10: on CUDA the dW / dx products round to bf16 under mixed
    precision, where JAX asks for float32. In float32 mode every stream and
    product is float32: x and each weight's gradient through the port's
    layer (the float32 walk's plain version here, its kernel on the card)
    meet jax.grad through the JAX Pallas route in float32 within GRAD_TOL."""
    rng = np.random.default_rng(7 + bidi)
    t, lens, d_in, hidden = 9, np.array([9, 4, 1], np.int32), 12, 8
    x = rng.normal(size=(t, len(lens), d_in)).astype(np.float32)

    def weights():
        return [rng.uniform(-0.3, 0.3, s).astype(np.float32)
                for s in ((d_in, 3 * hidden), (hidden, 3 * hidden), 3 * hidden, 3 * hidden)]

    ws = [weights(), weights()] if bidi else [weights()]
    r_out = rng.normal(size=(t, len(lens), hidden)).astype(np.float32)

    def jloss(x, *flat):
        dirs = [jrnn.GRUWeights(*flat[4 * k:4 * k + 4]) for k in range(len(ws))]
        out, _ = jrnn.gru_layer(x, jnp.asarray(lens), dirs[0], dirs[1] if bidi else None,
                                impl="pallas")
        return jnp.sum(out * r_out)

    flat = [jnp.asarray(a) for w in ws for a in w]
    ref = jax.grad(jloss, argnums=tuple(range(1 + len(flat))))(jnp.asarray(x), *flat)
    leaves = [torch.from_numpy(x).requires_grad_(True)] + [
        torch.from_numpy(a).requires_grad_(True) for w in ws for a in w]
    dirs = [trnn.GRUWeights(*leaves[1 + 4 * k:5 + 4 * k]) for k in range(len(ws))]
    out, _ = trnn.gru_layer(leaves[0], torch.from_numpy(lens), dirs[0],
                            dirs[1] if bidi else None)
    got = torch.autograd.grad((out * torch.from_numpy(r_out)).sum(), leaves)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("bidi", [True, False])
@pytest.mark.parametrize("rnn_type", ["lstm", "rnn"])
def test_float32_lstm_and_tanh_gradients_keep_float32_c10_c12(rnn_type, bidi):
    """C12: under bf16 on CUDA the projection x @ w_ih is rounded to bf16
    before its bias is added (the LSTM's in the walk, with b_hh, in f32),
    where the JAX package rounds x @ w_ih + b_ih; C10 as for the GRU. In
    float32 mode the LSTM's projection is x @ w_ih in float32, its walk
    adding b_ih + b_hh, the tanh RNN's x @ w_ih + b_ih + b_hh in float32;
    nothing is rounded below float32, and the walks and the dW / dx products
    run in float32: the port's layer (the float32 walks' plain versions
    here, their kernels on the card) meets jax.grad through the JAX Pallas
    route in float32 within GRAD_TOL."""
    lstm = rnn_type == "lstm"
    gates = 4 if lstm else 1
    rng = np.random.default_rng(17 + bidi + 2 * lstm)
    t, lens, d_in, hidden = 9, np.array([9, 4, 1], np.int32), 12, 8
    x = rng.normal(size=(t, len(lens), d_in)).astype(np.float32)

    def weights():
        return [rng.uniform(-0.3, 0.3, s).astype(np.float32)
                for s in ((d_in, gates * hidden), (hidden, gates * hidden),
                          gates * hidden, gates * hidden)]

    ws = [weights(), weights()] if bidi else [weights()]
    r_out = rng.normal(size=(t, len(lens), hidden)).astype(np.float32)
    jcls, jlayer = ((jrnn.LSTMWeights, jrnn.lstm_layer) if lstm
                    else (jrnn.RNNWeights, jrnn.rnn_tanh_layer))
    tcls, tlayer = ((trnn.LSTMWeights, trnn.lstm_layer) if lstm
                    else (trnn.RNNWeights, trnn.rnn_tanh_layer))

    # the projection the kernels read, in float32: the LSTM's the bare
    # product (its walk adds b_ih + b_hh), the tanh RNN's with both biases
    w0 = tcls(*map(torch.from_numpy, ws[0]))
    xt = torch.from_numpy(x)
    proj = trnn._lstm_product(xt, w0) if lstm else trnn._rnn_project(xt, w0)
    bias = torch.zeros(gates * hidden) if lstm else w0.b_ih + w0.b_hh
    assert proj.dtype == torch.float32 and torch.equal(proj, xt @ w0.w_ih + bias)
    exact = x.astype(np.float64) @ ws[0][0].astype(np.float64) + bias.double().numpy()
    np.testing.assert_allclose(proj.numpy(), exact, rtol=1e-6, atol=1e-6)
    if lstm:
        walk_bias = trnn._lstm_bias(w0)
        assert walk_bias.dtype == torch.float32
        assert torch.equal(walk_bias, w0.b_ih + w0.b_hh)

    def jloss(x, *flat):
        dirs = [jcls(*flat[4 * k:4 * k + 4]) for k in range(len(ws))]
        out = jlayer(x, jnp.asarray(lens), dirs[0], dirs[1] if bidi else None,
                     impl="pallas")
        return jnp.sum(out * r_out)

    flat = [jnp.asarray(a) for w in ws for a in w]
    ref = jax.grad(jloss, argnums=tuple(range(1 + len(flat))))(jnp.asarray(x), *flat)
    leaves = [torch.from_numpy(x).requires_grad_(True)] + [
        torch.from_numpy(a).requires_grad_(True) for w in ws for a in w]
    dirs = [tcls(*leaves[1 + 4 * k:5 + 4 * k]) for k in range(len(ws))]
    out = tlayer(leaves[0], torch.from_numpy(lens), dirs[0], dirs[1] if bidi else None)
    got = torch.autograd.grad((out * torch.from_numpy(r_out)).sum(), leaves)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=GRAD_TOL, atol=GRAD_TOL)
