"""The lookahead stencil (``ops/lookahead_cuda.py``, ``csrc/lookahead.cu``).

CPU cases: the differentiable wrapper on the plain path (forward, dx, dw)
against autograd of the stacked formulation, the past-tap walk that dx takes
against the transposed stencil, the wrapper's refusals, what the launch hands
its C entry, and the count of launches that one ``forward`` makes.

CUDA cases, skipped without a card (the ``card`` fixture decides at run
time): the kernel against the plain version and autograd's gradients at the
shapes of the serving and training paths and ragged ones, a non-contiguous
slice of H, and the launches of one ``forward``. On the card, with no JAX
installed: ``python -m pytest tests/test_torch_lookahead.py --noconftest``.
"""

import os
import re

import pytest
import torch

from danspeech_tpu_torch.models import deepspeech as tds
from danspeech_tpu_torch.models.config import DeepSpeechConfig as TConfig
from danspeech_tpu_torch.ops import cuda_build, lookahead_cuda
from danspeech_tpu_torch.ops.conv import LookaheadParams
from danspeech_tpu_torch.ops.conv import lookahead as conv_lookahead
from danspeech_tpu_torch.ops.precision import full_float32

# Every tolerance below covers float32 sums of the same products in another
# order: C = 20 fused multiply-adds in the stencil (against the einsum's
# reduction), T * B terms in dw. A sum of n float32 terms in any order is
# within n * 2^-24 of the sum of their magnitudes; these leave 4x or more.
STENCIL_RTOL = 1e-5   # of the largest output: 20 * 6e-8 = 1.2e-6, x8
DX_RTOL = 1e-5        # the same 20-term sums walked the other way
DW_RTOL = 1e-4        # of the largest dw: sums over T * B <= 51,328 terms,
                      # pairwise in both reductions


def _inputs(t, b, h, context=20, seed=0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(t, b, h, generator=gen)
    w = torch.randn(h, context, generator=gen)
    g = torch.randn(t, b, h, generator=gen)
    return x.to(device), w.to(device), g.to(device)


def _close(got, ref, rtol):
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    torch.testing.assert_close(got, ref, rtol=0.0, atol=rtol * max(scale, 1e-30))


def _grads(fn, x, w, g):
    """(out, dx, dw) of fn(x, w) with the upstream gradient g."""
    x = x.detach().clone().requires_grad_(True)
    w = w.detach().clone().requires_grad_(True)
    out = fn(x, w)
    dx, dw = torch.autograd.grad(out, (x, w), g)
    return out.detach(), dx, dw


# ---------------------------------------------------------------------------
# CPU: the plain path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("h", [64, 67])
@pytest.mark.parametrize("t", [1, 19, 20, 21, 57])
def test_function_matches_autograd_of_the_stack(t, b, h):
    """The autograd.Function's forward equals the stacked formulation
    bit for bit (the same code on the CPU); its dx (the past-tap walk) and
    dw (one shifted pass a tap) equal autograd through the stack."""
    x, w, g = _inputs(t, b, h, seed=t * 100 + h + b)
    out, dx, dw = _grads(lookahead_cuda.lookahead, x, w, g)
    ref, dx_ref, dw_ref = _grads(lookahead_cuda.lookahead_plain, x, w, g)
    assert torch.equal(out, ref)
    _close(dx, dx_ref, DX_RTOL)
    _close(dw, dw_ref, DW_RTOL)
    assert dx.shape == x.shape and dw.shape == w.shape


@pytest.mark.parametrize("t,context", [(1, 20), (7, 3), (20, 20), (33, 20), (5, 8)])
def test_past_walk_is_the_transposed_stencil(t, context):
    """``lookahead_past_plain`` is the transpose of the stencil: for each h
    the stencil is the T x T band matrix M[t, s] = w[h, s - t] (0 <= s - t <
    C), and the past walk of g is M^T g."""
    h = 5
    x, w, g = _inputs(t, 2, h, context, seed=t + context)
    eye = torch.arange(t)
    lag = eye[None, :] - eye[:, None]  # s - t
    band = torch.where((lag >= 0) & (lag < context),
                       w[:, lag.clamp(0, context - 1)], torch.zeros(()))  # (H, T, T)
    stencil = torch.einsum("hts,sbh->tbh", band, x)
    past = torch.einsum("hts,tbh->sbh", band, g)
    _close(lookahead_cuda.lookahead_plain(x, w), stencil, STENCIL_RTOL)
    _close(lookahead_cuda.lookahead_past_plain(g, w), past, DX_RTOL)
    _close(lookahead_cuda.stencil(g, w, reverse=True), past, DX_RTOL)


def test_conv_lookahead_takes_the_wrapper_in_float32():
    """``ops/conv.py``'s lookahead keeps its signature: bf16 weights and
    inputs are taken in float32, as before."""
    x, w, _ = _inputs(9, 2, 8, 4)
    got = conv_lookahead(x.bfloat16(), LookaheadParams(w.bfloat16()))
    ref = lookahead_cuda.lookahead_plain(x.bfloat16().float(), w.bfloat16().float())
    assert got.dtype == torch.float32 and torch.equal(got, ref)


@pytest.mark.parametrize("x_shape,w_shape,dtypes,error", [
    ((4, 2, 8), (8, 3), (torch.float64, torch.float32), TypeError),
    ((4, 2, 8), (8, 3), (torch.float32, torch.bfloat16), TypeError),
    ((4, 2, 8), (8, 3), (torch.bfloat16, torch.bfloat16), TypeError),
    ((4, 16), (16, 3), (torch.float32, torch.float32), ValueError),
    ((4, 2, 8), (7, 3), (torch.float32, torch.float32), ValueError),
    ((4, 2, 8), (8, 3, 1), (torch.float32, torch.float32), ValueError),
    ((0, 2, 8), (8, 3), (torch.float32, torch.float32), ValueError),
    ((4, 2, 8), (8, 0), (torch.float32, torch.float32), ValueError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(x_shape, w_shape, dtypes, error):
    x = torch.zeros(x_shape, dtype=dtypes[0])
    w = torch.zeros(w_shape, dtype=dtypes[1])
    with pytest.raises(error):
        lookahead_cuda.lookahead(x, w)
    with pytest.raises(error):
        lookahead_cuda.stencil(x, w, reverse=True)


def _c_signature():
    """(pointers, ints) of lookahead_stencil_launch in csrc/lookahead.cu,
    the trailing stream left out."""
    with open(os.path.join(cuda_build.CSRC_DIR, "lookahead.cu")) as f:
        text = re.sub(r"//[^\n]*", "", f.read())
    m = re.search(r'extern "C" int lookahead_stencil_launch\((.*?)\)\s*\{', text, re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    assert params[-1] == "void* stream"
    kinds = ["ptr" if "*" in p else "int" for p in params[:-1]]
    assert kinds == sorted(kinds, key=lambda k: k != "ptr"), "pointers first, then ints"
    return kinds.count("ptr"), kinds.count("int")


@pytest.mark.parametrize("reverse", [False, True])
def test_launch_hands_its_c_entry_the_shape(monkeypatch, reverse):
    """What the launch binds and passes (recorded on CPU tensors, no
    launch): x, w and a new output of x's shape, then (T, B, H, C,
    reverse), as many as the C signature has."""
    bound, calls = [], []
    monkeypatch.setattr(cuda_build, "bind", lambda *a: bound.append(a) or a)
    monkeypatch.setattr(cuda_build, "call",
                        lambda fn, name, dev, *args: calls.append(args))
    x, w, _ = _inputs(6, 3, 12, 5)
    out = lookahead_cuda._launch(x, w, reverse)
    (source, fn_name, n_ptr, n_int), = bound
    assert (source, fn_name) == ("lookahead", "lookahead_stencil_launch")
    assert (n_ptr, n_int) == _c_signature()
    (args,) = calls
    assert list(args[:2]) == [x.data_ptr(), w.data_ptr()]
    assert args[2] == out.data_ptr() and out.shape == x.shape and out.dtype == torch.float32
    assert list(args[3:]) == [6, 3, 12, 5, int(reverse)]
    with pytest.raises(ValueError, match="contiguous"):
        lookahead_cuda._launch(x, w.t().contiguous().t(), reverse)


UNI = dict(model_name="uni", rnn_hidden_size=16, rnn_layers=1, conv_layers=2,
           bidirectional=False)


@pytest.mark.parametrize("bidirectional,launches", [(False, 1), (True, 0)])
def test_one_forward_launches_the_stencil_once(monkeypatch, bidirectional, launches):
    """With the card's route taken on CPU tensors (the launch replaced by the
    plain version), one forward of a unidirectional model moves
    ``design_counts["stencil"]`` by exactly 1, a bidirectional one by 0, and
    the probabilities are those of the CPU path."""
    cfg = TConfig(**dict(UNI, bidirectional=bidirectional))
    params = tds.init_params(cfg, seed=3)
    gen = torch.Generator().manual_seed(4)
    spect = torch.randn(2, 1, 161, 40, generator=gen)
    lengths = torch.tensor([40, 23])
    ref, _ = tds.forward(params, cfg, spect, lengths)
    monkeypatch.setattr(lookahead_cuda, "_on_card", lambda x: True)
    monkeypatch.setattr(lookahead_cuda, "_launch",
                        lambda x, w, reverse: lookahead_cuda.lookahead_plain(x, w))
    before = dict(lookahead_cuda.lookahead.design_counts)
    n0 = lookahead_cuda.lookahead.launches
    got, _ = tds.forward(params, cfg, spect, lengths)
    moved = lookahead_cuda.lookahead.design_counts["stencil"] - before["stencil"]
    assert moved == launches
    assert lookahead_cuda.lookahead.launches - n0 == launches
    assert torch.equal(got, ref)


# ---------------------------------------------------------------------------
# CUDA: the kernel
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the stencil kernel runs only on a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("h", [2000, 800, 667, 64])
@pytest.mark.parametrize("b", [1, 3, 128])
@pytest.mark.parametrize("t", [1, 5, 19, 20, 21, 401])
def test_kernel_matches_plain(card, t, b, h):
    """Forward and past walk against the stacked plain version on the card
    (TF32 off for the einsum: the kernel is float32 throughout)."""
    x, w, g = _inputs(t, b, h, seed=t + b + h, device=card)
    with full_float32(card):
        ref = lookahead_cuda.lookahead_plain(x, w)
        past = lookahead_cuda.lookahead_past_plain(g, w)
    _close(lookahead_cuda.stencil(x, w), ref, STENCIL_RTOL)
    _close(lookahead_cuda.stencil(g, w, reverse=True), past, DX_RTOL)
    torch.cuda.synchronize()


@pytest.mark.parametrize("t,b,h", [(1, 3, 64), (21, 3, 667), (401, 128, 2000),
                                   (57, 1, 800)])
def test_kernel_gradients_match_autograd(card, t, b, h):
    x, w, g = _inputs(t, b, h, seed=7 * t + h, device=card)
    with full_float32(card):
        ref, dx_ref, dw_ref = _grads(lookahead_cuda.lookahead_plain, x, w, g)
    out, dx, dw = _grads(lookahead_cuda.lookahead, x, w, g)
    _close(out, ref, STENCIL_RTOL)
    _close(dx, dx_ref, DX_RTOL)
    _close(dw, dw_ref, DW_RTOL)


@pytest.mark.parametrize("hs", [slice(0, 1000), slice(1000, 2000), slice(3, 670)])
def test_kernel_takes_a_slice_of_h(card, hs):
    """tp.py hands ``x[..., hs]`` (not contiguous) and ``w[hs]``."""
    x, w, _ = _inputs(401, 8, 2000, seed=hs.start, device=card)
    xs, ws = x[..., hs], w[hs]
    assert not xs.is_contiguous()
    with full_float32(card):
        ref = lookahead_cuda.lookahead_plain(xs.contiguous(), ws)
    _close(lookahead_cuda.lookahead(xs, ws), ref, STENCIL_RTOL)


def test_kernel_refuses_a_long_context(card):
    x, _, _ = _inputs(8, 2, 4, device=card)
    w = torch.zeros(4, lookahead_cuda.MAX_CONTEXT + 1, device=card)
    with pytest.raises(ValueError, match="taps"):
        lookahead_cuda.lookahead(x, w)


@pytest.mark.parametrize("bidirectional,launches", [(False, 1), (True, 0)])
def test_one_forward_on_the_card_launches_once(card, bidirectional, launches):
    """One float32 forward on the card moves ``design_counts["stencil"]`` by
    exactly 1 (unidirectional) or 0 (bidirectional), and its probabilities
    are the CPU path's (float32 on both, TF32 off; the GRU walks differ by
    summation order)."""
    cfg = TConfig(**dict(UNI, bidirectional=bidirectional))
    params = tds.init_params(cfg, seed=3)
    spect = torch.randn(2, 1, 161, 40, generator=torch.Generator().manual_seed(4))
    lengths = torch.tensor([40, 23])
    ref, _ = tds.forward(params, cfg, spect, lengths)
    n0 = lookahead_cuda.lookahead.design_counts["stencil"]
    with full_float32(card):
        got, _ = tds.forward(tds.params_to(params, card), cfg, spect.to(card),
                             lengths.to(card))
    assert lookahead_cuda.lookahead.design_counts["stencil"] - n0 == launches
    torch.testing.assert_close(got.cpu(), ref, rtol=0.0, atol=1e-4)
