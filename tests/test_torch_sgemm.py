"""The float32 GEMM of the float32 recurrent kernels on its own
(danspeech_tpu_torch/ops/gru_cuda.py:sgemm_f32, csrc/sgemm.cuh): its plain
version on CPU tensors against numpy float64 and the JAX package's
HIGHEST-precision product, what the wrapper refuses before any launch, what
it hands its C entry (CPU tensors that report CUDA, no launch), and the
kernel's tile constants against the card's shared memory: no CUDA device
is needed.
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from danspeech_tpu_torch.ops import cuda_build, gru_cuda
from danspeech_tpu_torch.ops import persist_plan as pp

# a float32 product against float64, over K x max|a| x max|b|: float32
# rounding of K products and their sum (eps 6e-8 a product, about sqrt(K)
# of them adding up) stays far below this at these K
REL = 1e-6


class _OnCuda:
    """A CPU tensor that reports a CUDA device: it takes the wrapper's CUDA
    branch up to its launch, with no card."""

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        if name == "device":
            return torch.device("cuda")
        return getattr(self._t, name)


def _operands(seed, a_shape, b_shape):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(a_shape).astype(np.float32)
    b = (rng.uniform(-1, 1, b_shape) / np.sqrt(b_shape[-2])).astype(np.float32)
    return a, b


def _rel_err(got, want, a, b):
    k = a.shape[-1]
    return float(np.abs(got - want).max()) / (k * np.abs(a).max() * np.abs(b).max())


@pytest.mark.parametrize("a_shape,b_shape", [
    ((37, 50), (50, 300)),           # B3's projection at a small width: D = 50, 3H = 300
    ((37, 50), (2, 50, 300)),        # both directions, x shared
    ((2, 26, 70), (2, 70, 280)),     # the LSTM recompute of a pair at H = 70
    ((1, 9, 7), (2, 7, 3)),          # a one-plane operand shared by both products
    ((64, 800), (800, 3200)),        # B7's recompute width
])
def test_plain_gemm_matches_float64(a_shape, b_shape):
    a, b = _operands(sum(a_shape) + sum(b_shape), a_shape, b_shape)
    got = gru_cuda.sgemm_f32(torch.from_numpy(a), torch.from_numpy(b))
    want = np.matmul(a.astype(np.float64), b.astype(np.float64))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel_err(got.numpy(), want, a, b) <= REL


def test_plain_gemm_matches_the_jax_package_product():
    """The product the JAX package's float32 kernels take (x @ w_ih and
    hprev @ w_hh in float32) at HIGHEST precision, on the same inputs."""
    a, b = _operands(3, (2, 40, 96), (2, 96, 288))
    with jax.default_device(jax.devices("cpu")[0]):
        want = np.asarray(jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST))
    got = gru_cuda.sgemm_f32(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert _rel_err(got, want.astype(np.float64), a, b) <= REL


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    a, b = _operands(4, (12, 8), (2, 8, 16))
    before = gru_cuda.sgemm_f32.launches
    got = gru_cuda.sgemm_f32(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(got, gru_cuda.sgemm_f32_plain(torch.from_numpy(a), torch.from_numpy(b)))
    assert gru_cuda.sgemm_f32.launches == before


@pytest.mark.parametrize("a,b,error,match", [
    (torch.empty(4, 8, dtype=torch.bfloat16), torch.empty(8, 4), TypeError, "float32"),
    (torch.empty(4, 8), torch.empty(8, 4, dtype=torch.float64), TypeError, "float32"),
    (torch.empty(4, 8), torch.empty(6, 4), ValueError, "depths differ"),
    (torch.empty(3, 4, 8), torch.empty(8, 4), ValueError, "1 or 2 planes"),
    (torch.empty(8), torch.empty(8, 4), ValueError, "2-D"),
    (torch.empty(8, 4).t(), torch.empty(8, 4), ValueError, "contiguous"),
    (torch.empty(2, 4, 8), torch.empty(2, 8, 4)[:1].expand(2, 8, 4), ValueError,
     "contiguous"),
    (torch.empty(0, 8), torch.empty(8, 4), ValueError, "M, N, K"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, a, b, error, match):
    def no_launch(*args):
        raise AssertionError("launched")

    monkeypatch.setattr(cuda_build, "bind", no_launch)
    monkeypatch.setattr(cuda_build, "call", no_launch)
    before = gru_cuda.sgemm_f32.launches
    with pytest.raises(error, match=match):
        gru_cuda.sgemm_f32(_OnCuda(a), _OnCuda(b))
    assert gru_cuda.sgemm_f32.launches == before


def test_wrapper_refuses_planes_that_differ(monkeypatch):
    monkeypatch.setattr(gru_cuda, "_sgemm", lambda *a: pytest.fail("launched"))
    with pytest.raises(ValueError, match="planes"):
        gru_cuda.sgemm_f32(_OnCuda(torch.empty(2, 4, 8)), _OnCuda(torch.empty(1, 8, 4)))


def _c_signature(fn_name):
    with open(f"{cuda_build.CSRC_DIR}/gru_f32.cu") as f:
        text = re.sub(r"//[^\n]*", "", f.read())
    m = re.search(r'extern "C" int ' + fn_name + r"\((.*?)\)\s*\{", text, re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    assert params[-1] == "void* stream"
    return ["ptr" if "*" in p else "int" for p in params[:-1]]


@pytest.mark.parametrize("a_shape,b_shape,z", [((6, 5), (5, 3), 1), ((6, 5), (2, 5, 3), 2),
                                               ((2, 6, 5), (2, 5, 3), 2),
                                               ((2, 6, 5), (5, 3), 2), ((1, 6, 5), (5, 3), 1),
                                               ((1, 6, 5), (2, 5, 3), 2)])
def test_route_hands_its_c_entry_the_planes_and_sizes(monkeypatch, a_shape, b_shape, z):
    """sgemm_f32_launch takes (a_0, a_1, b_0, b_1, c_0, c_1, M, N, K, nz):
    each product's planes (a shared operand fills both), the output's
    planes, the sizes and the number of products; one launch is counted."""
    kinds = _c_signature("sgemm_f32_launch")
    assert kinds == ["ptr"] * 6 + ["int"] * 4
    rec = {}

    def call(fn, name, dev, *args):
        rec["args"] = args
        m, n = args[6], args[7]
        out = np.ctypeslib.as_array(ctypes.cast(args[4], ctypes.POINTER(ctypes.c_float)),
                                    shape=(m, n))
        out[:] = 7.0  # what the kernel writes into plane 0

    monkeypatch.setattr(cuda_build, "bind", lambda *a: rec.setdefault("bound", a))
    monkeypatch.setattr(cuda_build, "call", call)
    a, b = torch.randn(*a_shape), torch.randn(*b_shape)
    before = gru_cuda.sgemm_f32.launches
    got = gru_cuda._sgemm(a, b, z)
    assert rec["bound"] == ("gru_f32", "sgemm_f32_launch", 6, 4)
    assert gru_cuda.sgemm_f32.launches == before + 1
    args = rec["args"]
    m, k = a_shape[-2:]
    n = b_shape[-1]
    assert list(args[6:]) == [m, n, k, z]

    def planes(t):
        return [t[i].data_ptr() for i in range(z)] if t.dim() == 3 and t.shape[0] == z \
            else [t.data_ptr()] * z

    want_a, want_b = planes(a), planes(b)
    assert list(args[0:2]) == want_a + want_a[:1] * (2 - z)
    assert list(args[2:4]) == want_b + want_b[:1] * (2 - z)
    assert tuple(got.shape) == (z, m, n) and got.dtype == torch.float32
    assert args[4] == got[0].data_ptr() and bool((got[0] == 7.0).all())
    assert args[5] == (got[1].data_ptr() if z == 2 else args[4])


def _defines():
    with open(f"{cuda_build.CSRC_DIR}/sgemm.cuh") as f:
        text = f.read()
    found = dict(re.findall(r"^#define (SG_\w+) (\d+)", text, re.M))
    return {k: int(v) for k, v in found.items()}, text


def test_gemm_tile_constants_fit_the_card_and_cover_the_tile():
    """SG_BLOCKS rings of SG_STAGES stages of A's and B's chunks, each on its
    1024-byte boundary, fit an H100's SM; a chunk of A's rows is the 128
    bytes of the swizzle; the eight warps' 8 x 8 sums a thread cover the 128
    x 128 tile; 128 registers a thread leave room for SG_BLOCKS blocks."""
    d, text = _defines()
    bm, bn, bk = d["SG_BM"], d["SG_BN"], d["SG_BK"]
    ring = d["SG_STAGES"] * (bm * bk + bk * bn) * 4
    assert ring + 1024 <= pp.H100_SMEM_OPTIN - pp.STATIC_RESERVE
    per_sm = 233_472  # an H100 SM's shared memory, 1 KB of it kept a block
    assert d["SG_BLOCKS"] * (ring + 1024 + 1024) <= per_sm
    assert bk * 4 == 128 and "CU_TENSOR_MAP_SWIZZLE_128B" in text
    assert d["SG_THREADS"] * 8 * 8 == bm * bn
    assert d["SG_THREADS"] * d["SG_BLOCKS"] * 128 <= 65536
    assert "__launch_bounds__(SG_THREADS, SG_BLOCKS)" in text
    assert bm <= 256 and bn <= 256  # a TMA box is at most 256 elements a side
    # what a thread reads: 8 rows 4 apart, 8 columns in 2 runs 32 apart
    assert "float acc[8][8];" in text and "wrow + 4 * r" in text
    # both float32 files that run the GEMM include it after persist.cuh
    for name in ("gru_f32.cu", "lstm_f32.cu"):
        with open(f"{cuda_build.CSRC_DIR}/{name}") as f:
            src = f.read()
        assert src.index('#include "persist.cuh"') < src.index('#include "sgemm.cuh"')


def test_swizzled_reads_of_a_thread_are_its_rows_and_depths():
    """The offsets the kernel computes (sg_a_off, mirrored here): a thread's
    two depths of one row are one 8-byte run, the two rows of a half-warp's
    load lie in distinct 16-byte bank groups, and every (row, depth) of a
    chunk has one place."""
    _, text = _defines()
    assert "return m * SG_BK + ((((k >> 2) ^ m) & 7) << 2) + (k & 3);" in text

    def off(row, k):
        return row * 32 + ((((k >> 2) ^ row) & 7) << 2) + (k & 3)

    places = {off(r, k) for r in range(128) for k in range(32)}
    assert places == set(range(128 * 32))
    for wm in range(4):
        for kp in range(16):  # pairs of depths
            for r in range(8):
                # one 8-byte load: each half-warp holds two rows (tm, tm + 1)
                for half in ((0, 1), (2, 3)):
                    groups = {(off(wm * 32 + tm + 4 * r, 2 * kp) % 32) // 4 for tm in half}
                    assert len(groups) == 2
                for tm in range(4):
                    base = off(wm * 32 + tm + 4 * r, 2 * kp)
                    assert base % 2 == 0 and off(wm * 32 + tm + 4 * r, 2 * kp + 1) == base + 1
