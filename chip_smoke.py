#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (danspeech_tpu_torch).

    python3 chip_smoke.py            # every phase, needs one CUDA card
    python3 chip_smoke.py --kernels  # phases 1-3 only (build + kernel checks)
    python3 chip_smoke.py --lm-serving  # phases 1, 2 and 8 only
    python3 chip_smoke.py --phase-clocks  # where a persistent kernel's step
                                          # spends its clocks (-DPS_PROFILE build)

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA kernel from ``danspeech_tpu_torch/csrc`` (one nvcc per
   source, all started together), timed;
3. the grid barrier of ``csrc/persist.cuh`` alone (timed, and a grid too
   large to be co-resident must be refused); then each of the nine kernels
   (four GRU, three LSTM, two tanh-RNN) against its plain PyTorch version on
   the card at ragged small shapes and the layer shapes of the paths below,
   with its time, the plain version's time, one library call's time (bf16
   and float16) as a yardstick, and the bound; every kernel in both designs
   (``design="persistent"`` and ``"step"``, both checked and timed in the
   same run; ``gru_bwd_scan``, the LSTM and the tanh-RNN ones also as a
   pair of chains in one launch), and every main path below must take the
   persistent one; and
   ``gru_layer`` with concatenated directions and with a carried h0, the two
   routes that reach ``gru_scan_bidi``;
4. the batch path: ``Recognizer.recognize`` / ``recognize_batch`` on the
   flagship DanSpeechPrimary (3 conv, 9x1200 bidirectional GRU, random
   weights from a seed), with the kernels' launch counts read around it,
   one batch checked against the plain GRU on the card, and a small model
   checked against the port's CPU path;
5. the streaming path on GPUStreamingRNN (2 conv, 5x2000 unidirectional
   GRU, lookahead 20, random weights from a seed) with the flagship as the
   secondary model: ``recognize_batch`` of 128 waveforms, then
   ``enable_real_time_streaming`` and ``streaming_transcribe`` over 8 s of
   seeded audio (each chunk timed), then ``real_time_streaming`` over a
   seeded WAV file read at the pace of a live microphone; the launch counts
   of each path read around it, every chunk's probabilities checked against
   the plain GRU on the card;
6. the training path: ``train.make_wave_train_step`` on the flagship at
   full width and depth (mixed precision, remat; 3 steps on one seeded
   batch of 32 waveforms of 1-8 s, one more with SpecAugment), each step's
   loss, wall time and launch counts, the peak device memory and a profile
   of one step; the gradients of one 8-row batch through the kernels
   against the same step on the plain GRU; 2 steps of a 2-conv, 2x2000
   unidirectional model; then ``train.train`` on a manifest of seeded WAVs
   with checkpoints, ``continue_training`` from them, ``export_model`` and
   ``Recognizer.recognize`` of the exported ``.dsz`` (3x1200);
7. the LSTM and tanh-RNN models, served and trained: ``LSTM5x800`` and
   ``Tanh5x800`` (2 conv, RNN input 1312, 5 bidirectional layers of width
   800, what ``python -m danspeech_tpu_torch.train --rnn-type lstm|rnn``
   builds; random weights from a seed) through ``Recognizer.recognize`` and
   ``recognize_batch`` of 128 waveforms, one dispatch group checked against
   the plain recurrence on the card; ``make_wave_train_step`` steps on one
   seeded batch of 32 waveforms of 1-8 s with their launch counts (per LSTM
   step 5 ``lstm_scan``, 5 ``lstm_scan_with_cell``, each a pair of chains in
   one launch, and 10 ``lstm_bwd_scan`` chains in 5 paired launches; per tanh
   step 20 ``rnn_tanh_scan`` chains in 10 paired launches and 10
   ``rnn_tanh_bwd_scan`` chains in 5; a tanh dispatch group 10
   ``rnn_tanh_scan`` chains in 5), the gradients of an 8-row batch against
   the plain path, a profile of one batch and of one step; for the LSTM
   ``train.train`` + ``export_model`` + ``Recognizer.recognize`` on a
   2-layer cut;
8. serving with a language model: a seeded synthetic 3-gram LM (20,000
   words, 100,000 bigrams and 100,000 trigrams, as ARPA text; its load time,
   and the pack time and bytes of its device tables); the beam searches on
   speech-like probabilities spelling word sequences of the LM (B=128,
   T=401, C=33, beam 64, alpha 1.3, beta 0.2): the device beam on the card
   against the device beam on the CPU and the C++ host beam, top-1 on
   every row (a row that differs must be a float32 near tie: the same
   search with float64 scores picks the host beam's transcript, and the
   scores lie within BEAM_GAP_REL); the decode alone, host against device, at batches of 1 to
   128 and the crossover that ``decode/beam_auto.py:DEFAULT_CROSSOVER``
   takes; ``Recognizer.recognize_batch`` of 128 waveforms of 1-8 s and
   ``recognize`` of a 1 s clip on the flagship for greedy and
   ``backend="host"``, ``"device"`` and ``"auto"`` (audio-s/s, 9
   ``gru_bidi_fused`` launches a dispatch group, a profile of one
   device-beam batch; the backends' transcripts equal row for row or near
   ties); ``streaming_transcribe`` on GPUStreamingRNN with the LM and no
   secondary model (the final chunk's time; the final string against the
   device beam's decode of the same probabilities); one ``{"lm_serving":
   ...}`` line;
9. one ``{"kernels": [...]}`` line of nine entries, then the device line as
   the last line.

Imports no JAX and nothing of ``danspeech_tpu``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import wave

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# kernel vs plain on the card: identical bf16-rounded operands and f32
# accumulation, so they differ only by summation order, which can flip the
# bf16 rounding of one h element and carry on through the recurrence: allow
# about five bf16 ulps at |h| < 1
GRU_ATOL = 2e-2

# wrapper name -> the source under danspeech_tpu_torch/csrc of the design its
# main path takes (gru_scan_bidi's step design is gru_scan_bidi.cu)
SOURCES = {"gru_bidi_fused": "gru_bidi_fused", "gru_scan": "gru_scan",
           "gru_scan_bidi": "gru_scan", "gru_bwd_scan": "gru_bwd",
           "lstm_scan": "lstm_scan", "lstm_scan_with_cell": "lstm_scan",
           "lstm_bwd_scan": "lstm_bwd", "rnn_tanh_scan": "rnn_tanh_scan",
           "rnn_tanh_bwd_scan": "rnn_tanh_bwd"}
# wrapper name -> line of the Pallas function in danspeech_tpu/ops/pallas_gru.py
REPLACES = {"gru_bidi_fused": 400, "gru_scan": 770, "gru_scan_bidi": 171,
            "gru_bwd_scan": 987, "lstm_scan": 577, "lstm_scan_with_cell": 1136,
            "lstm_bwd_scan": 1293, "rnn_tanh_scan": 706, "rnn_tanh_bwd_scan": 1416}

FLAGSHIP = dict(
    model_name="DanSpeechPrimary", rnn_hidden_size=1200, rnn_layers=9,
    conv_layers=3, bidirectional=True,
)
# the zoo's large streaming model: 2 conv (RNN input 1312), 5x2000
# unidirectional GRU, lookahead context 20
GPU_STREAMING = dict(
    model_name="GPUStreamingRNN", rnn_hidden_size=2000, rnn_layers=5,
    conv_layers=2, bidirectional=False, context=20,
)
# what the training CLI builds for --rnn-type lstm / rnn: 2 conv (RNN input
# 1312), 5 bidirectional layers of width 800, directions summed
LSTM5X800 = dict(
    model_name="LSTM5x800", rnn_type="lstm", rnn_hidden_size=800, rnn_layers=5,
    conv_layers=2, bidirectional=True,
)
TANH5X800 = dict(LSTM5X800, model_name="Tanh5x800", rnn_type="rnn")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else ""


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by name; each counts its launches."""
    from danspeech_tpu_torch.ops import gru_cuda, lstm_cuda, rnn_tanh_cuda

    return {
        "gru_bidi_fused": gru_cuda.gru_bidi_fused, "gru_scan": gru_cuda.gru_scan,
        "gru_scan_bidi": gru_cuda.gru_scan_bidi, "gru_bwd_scan": gru_cuda.gru_bwd_scan,
        "lstm_scan": lstm_cuda.lstm_scan,
        "lstm_scan_with_cell": lstm_cuda.lstm_scan_with_cell,
        "lstm_bwd_scan": lstm_cuda.lstm_bwd_scan,
        "rnn_tanh_scan": rnn_tanh_cuda.rnn_tanh_scan,
        "rnn_tanh_bwd_scan": rnn_tanh_cuda.rnn_tanh_bwd_scan,
    }


def zero_launches() -> None:
    for w in kernel_wrappers().values():
        w.launches = 0


def read_launches() -> dict:
    return {name: w.launches for name, w in kernel_wrappers().items()}


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean time of one call over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_by_kernel(fn, need: str | None = None, tries: int = 3) -> dict:
    """Device time of one call of ``fn`` by kernel name (torch.profiler), ms.
    Now and then the profiler returns a call without its device events (a
    persistent walk read 0 ms beside its 6 ms by CUDA events): a reading
    with no device time, or none for the kernel ``need`` names, is taken
    again, up to ``tries`` calls in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        out = {}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            out[e.key] = out.get(e.key, 0.0) + us / 1e3
        if out and (need is None or kernel_ms(out, need) > 0):
            break
    return out


def kernel_ms(split: dict, name: str) -> float:
    """The summed time of the kernels whose name starts with ``name`` (a
    template instance carries its arguments after the name)."""
    return sum(ms for k, ms in split.items()
               if k.split("<")[0].split("(")[0].strip().endswith(name))


DESIGNS = ("persistent", "step")


def require_persistent(wrapper, label):
    """The calls since the counts were last zeroed all took the persistent
    design."""
    counts = wrapper.design_counts
    log(f"  {label}: designs taken {counts}")
    if counts["step"] or not counts["persistent"]:
        raise AssertionError(f"{label}: expected the persistent design only, got {counts}")


def zero_designs():
    """The design counts of every wrapper, and the counts of paired
    launches (lstm_bwd_scan, rnn_tanh_scan, rnn_tanh_bwd_scan), to 0."""
    for w in kernel_wrappers().values():
        w.design_counts = dict.fromkeys(DESIGNS, 0)
        if hasattr(w, "pair_launches"):
            w.pair_launches = 0


def phase_barrier():
    """The grid barrier of csrc/persist.cuh alone: a cooperative launch of
    one block per SM, each holding 200 KB of shared memory, that takes 2000
    barriers and checks after each that another block's write before it is
    visible. Returns the time of one barrier for a full grid and for the 50
    and 75 blocks that one chain of the flagship uses."""
    import ctypes

    from danspeech_tpu_torch.ops import cuda_build, gru_cuda

    fn = cuda_build.load("gru_bwd").persist_barrier_probe_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms, smem_optin = gru_cuda.device_info(torch.device("cuda", torch.cuda.current_device()))
    log(f"  device: {sms} SMs, {smem_optin} bytes of shared memory a block")
    iters, smem = 2000, 200 * 1024
    res = {"sm_count": sms, "smem_optin": smem_optin, "iters": iters, "us": {}}
    for grid in (50, 75, sms):
        counter = torch.zeros(1, dtype=torch.int32, device="cuda")
        slots = torch.zeros(grid, dtype=torch.int32, device="cuda")
        errors = torch.zeros(1, dtype=torch.int32, device="cuda")

        def run():
            counter.zero_()
            rc = fn(counter.data_ptr(), slots.data_ptr(), errors.data_ptr(), grid, smem,
                    iters, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"barrier probe launch failed: CUDA error {rc}")

        ms = time_ms(run, iters=3)
        if int(errors) != 0 or int(counter) != grid * iters:
            raise AssertionError(f"barrier probe, {grid} blocks: {int(errors)} stale reads, "
                                 f"counter {int(counter)} of {grid * iters}")
        res["us"][grid] = ms * 1e3 / iters
        log(f"  grid barrier, {grid} blocks x 256 threads, {smem} B each: "
            f"{res['us'][grid]:.2f} us a barrier over {iters}, every write seen after it")
    # a grid beyond one block per SM must be refused, not hang
    rc = fn(counter.data_ptr(), slots.data_ptr(), errors.data_ptr(), sms + 1, smem, 1,
            torch.cuda.current_stream().cuda_stream)
    log(f"  {sms + 1} blocks of {smem} B: launch refused with CUDA error {rc}")
    if rc == 0:
        raise AssertionError("a grid that cannot be co-resident was launched")
    return res


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def gru_layer_inputs(gen, t, b, d, h, lengths):
    dev = "cuda"
    bound = 1.0 / h ** 0.5

    def uni(*shape):
        return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * bound

    x = torch.randn(t, b, d, generator=gen, device=dev).to(torch.bfloat16)
    w_ih = [uni(d, 3 * h).to(torch.bfloat16) for _ in range(2)]
    w_hh = [uni(h, 3 * h).to(torch.bfloat16) for _ in range(2)]
    b_ih = [uni(3 * h) for _ in range(2)]
    b_hh = [uni(3 * h) for _ in range(2)]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return (x, lens, w_ih[0], w_ih[1], w_hh[0], w_hh[1],
            b_ih[0], b_ih[1], b_hh[0], b_hh[1])


def gru_bound(t, b, d, h):
    """(bound_ms, bound_by): the larger of the operations over the bf16
    peak and the bytes (each input read once, each output written once)
    over the memory rate."""
    flops = 2 * 2 * t * b * (d + h) * 3 * h  # 2 directions, multiply-add = 2
    nbytes = (
        t * b * d * 2                  # x bf16
        + 2 * (d + h) * 3 * h * 2      # w_ih, w_hh bf16, both directions
        + 4 * 3 * h * 4 + b * 4        # biases f32, lengths int32
        + 2 * t * b * h * 2            # out_f, out_b bf16
        + 2 * b * h * 4                # h_last f32
    )
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def check_gru(gen, t, b, d, h, lengths, timed: bool):
    """gru_bidi_fused in both designs against its plain version; the plan
    must choose the persistent design at this shape."""
    from danspeech_tpu_torch.ops import gru_cuda, persist_plan

    args = gru_layer_inputs(gen, t, b, d, h, lengths)
    dev_info = gru_cuda.device_info(args[0].device)
    planned = persist_plan.plan_gru_forward(h, b, *dev_info)
    if planned.design != "persistent":
        raise AssertionError(f"gru_bidi_fused H={h} B={b}: planned {planned}")
    ref = gru_cuda.gru_bidi_fused_plain(*args)
    torch.cuda.synchronize()
    names = ("out_f", "out_b", "h_last_f", "h_last_b")
    tt = torch.arange(t, device="cuda")[:, None]
    pad = tt >= args[1][None, :].long()
    all_errs = {}
    for design in DESIGNS:
        got = gru_cuda.gru_bidi_fused(*args, design=design)
        torch.cuda.synchronize()
        errs = {}
        for name, g, r in zip(names, got, ref):
            if g.shape != r.shape or g.dtype != r.dtype:
                raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs {r.shape}/{r.dtype}")
            if not torch.isfinite(g.float()).all():
                raise AssertionError(f"{name} ({design}): non-finite values from the kernel")
            errs[name] = float((g.float() - r.float()).abs().max())
        # rows past their length must be exact zeros
        for name, g in zip(names[:2], got[:2]):
            if pad.any() and float(g[pad].float().abs().max()) != 0.0:
                raise AssertionError(f"{name} ({design}): non-zero output past a row's length")
        log(f"  gru_bidi_fused[{design}] T={t} B={b} D={d} H={h}: max|err| "
            + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
            + f" (atol {GRU_ATOL})")
        if not max(errs.values()) <= GRU_ATOL:
            raise AssertionError(f"gru_bidi_fused ({design}) disagrees with its plain "
                                 f"version: {max(errs.values())}")
        all_errs[design] = errs
        del got
    res = {
        "shape": {"T": t, "B": b, "D": d, "H": h},
        "max_abs_err": max(max(e.values()) for e in all_errs.values()),
        "errs": all_errs, "atol": GRU_ATOL,
        "plan": {"units": planned.units, "grid": planned.grid, "row_groups": planned.row_groups,
                 "k_splits": planned.k_splits, "stages": planned.stages,
                 "chunk_depth": planned.chunk_depth,
                 "smem_bytes": planned.smem_bytes},
    }
    if timed:
        def run(design):
            return lambda: gru_cuda.gru_bidi_fused(*args, design=design)

        # step, persistent, persistent, step: both designs on one card in one run
        step_a = time_ms(run("step"), iters=3)
        res["ms"] = 0.5 * (time_ms(run("persistent"), iters=5)
                           + time_ms(run("persistent"), iters=5))
        res["step_design_ms"] = 0.5 * (step_a + time_ms(run("step"), iters=3))
        res["design"] = "persistent"
        split = device_ms_by_kernel(run("persistent"), need="gru_persist_kernel")
        res["recurrence_ms"] = kernel_ms(split, "gru_persist_kernel")
        res["projection_ms"] = (kernel_ms(split, "gru_proj_wgmma_kernel")
                                + kernel_ms(split, "gru_proj_kernel"))
        res["step_ms"] = res["recurrence_ms"] / t
        res["projection_tflops"] = (2 * 2 * t * b * d * 3 * h
                                    / max(res["projection_ms"], 1e-9) / 1e9)
        res["plain_ms"] = time_ms(lambda: gru_cuda.gru_bidi_fused_plain(*args), iters=2)
        x = args[0]
        for key, dtype in (("library_ms", torch.bfloat16), ("library_fp16_ms", torch.float16)):
            # cuDNN wants its weights in one block: flatten_parameters makes it
            # for float16 only (see cudnn_rnn_ms)
            gru = torch.nn.GRU(d, h, bidirectional=True).to("cuda", dtype)
            gru.flatten_parameters()
            xd = x.to(dtype)
            with torch.no_grad():
                res[key] = time_ms(lambda: gru(xd), iters=3)
            del gru, xd
        res["bound_ms"], res["bound_by"] = gru_bound(t, b, d, h)
        log(f"    persistent ms={res['ms']:.3f} (recurrence {res['recurrence_ms']:.3f} = "
            f"{res['step_ms'] * 1e3:.2f} us a step, projection {res['projection_ms']:.3f} = "
            f"{res['projection_tflops']:.0f} TFLOP/s) step-design ms="
            f"{res['step_design_ms']:.3f} plain_ms={res['plain_ms']:.3f} "
            f"library_ms(cuDNN nn.GRU bf16)={res['library_ms']:.3f} "
            f"(float16: {res['library_fp16_ms']:.3f}) "
            f"bound_ms={res['bound_ms']:.3f} ({res['bound_by']})")
    del args, ref
    torch.cuda.empty_cache()
    return res


def phase_kernels():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    small = [
        check_gru(gen, 37, 5, 96, 64, [37, 1, 20, 36, 5], timed=False),
        # H and D no multiples of 8 (scalar load paths), a lone row, T = 1
        check_gru(gen, 9, 3, 50, 100, [9, 1, 4], timed=False),
        check_gru(gen, 1, 2, 96, 64, [1, 1], timed=False),
        check_gru(gen, 11, 1, 40, 72, [11], timed=False),
        # B above 128: two row blocks over the same resident slice
        check_gru(gen, 7, 150, 64, 72, [7, 1] + [1 + (i % 7) for i in range(148)],
                  timed=False),
        # the training batch: one 64-row block, the warpgroups split the depth
        check_gru(gen, 21, 32, 160, 200, [21, 1] + [1 + (i % 21) for i in range(30)],
                  timed=False),
    ]
    flag = []
    for d in (2016, 1200):
        rng = np.random.default_rng(d)
        lengths = rng.integers(1, 402, size=128)
        lengths[0], lengths[1] = 401, 1
        flag.append(check_gru(gen, 401, 128, d, 1200, lengths.tolist(), timed=True))
    rng = np.random.default_rng(32)
    lengths = rng.integers(1, 402, size=32)
    lengths[0], lengths[1] = 401, 1
    flag.append(check_gru(gen, 401, 32, 1200, 1200, lengths.tolist(), timed=True))
    return small + flag


def scan_bound(lengths, t, b, h):
    """(bound_ms, bound_by) of one gru_scan call: the operations of the
    valid steps over the bf16 peak against the bytes (gx of the valid steps
    read once, w_hh once, out written once, h0 read and h_last written)
    over the memory rate."""
    valid = int(sum(lengths))
    flops = 2 * valid * h * 3 * h
    nbytes = (
        valid * 3 * h * 2               # gx bf16, valid rows
        + h * 3 * h * 2                 # w_hh bf16
        + 2 * 3 * h * 4 + b * 4         # b_ih, b_hh f32, lengths int32
        + t * b * h * 2                 # out bf16
        + 2 * b * h * 4                 # h0, h_last f32
    )
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def scan_inputs(gen, t, lengths, h, carried):
    """Seeded operands of gru_scan: (gx, lengths, w_hh, b_ih, b_hh, h0)."""
    dev = "cuda"
    b = len(lengths)
    bound = 1.0 / h ** 0.5

    def uni(*shape):
        return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * bound

    gx = (torch.randn(t, b, 3 * h, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    w_hh = uni(h, 3 * h).to(torch.bfloat16)
    b_ih, b_hh = uni(3 * h), uni(3 * h)
    h0 = torch.zeros(b, h, device=dev)
    if carried:
        h0 = torch.rand(b, h, generator=gen, device=dev) - 0.5
    return gx, lens, w_hh, b_ih, b_hh, h0


def check_scan(gen, label, t, lengths, h, reverse, carried, timed):
    """gru_scan in both designs against its plain version; the plan must
    choose the persistent design at this shape."""
    from danspeech_tpu_torch.ops import gru_cuda, persist_plan

    dev = "cuda"
    b = len(lengths)
    args = scan_inputs(gen, t, lengths, h, carried)
    gx, lens = args[:2]
    planned = persist_plan.plan_gru_scan(h, b, *gru_cuda.device_info(gx.device))
    if planned.design != "persistent":
        raise AssertionError(f"gru_scan H={h} B={b}: planned {planned}")
    ref = gru_cuda.gru_scan_plain(*args, reverse=reverse)
    torch.cuda.synchronize()
    pad = torch.arange(t, device=dev)[:, None] >= lens[None, :].long()
    runs = {design: (lambda d=design: gru_cuda.gru_scan(*args, reverse=reverse, design=d))
            for design in DESIGNS}
    all_errs = {}
    for tag, run in runs.items():
        got = run()
        torch.cuda.synchronize()
        errs = {}
        for name, g, r in zip(("out", "h_last"), got, ref):
            if g.shape != r.shape or g.dtype != r.dtype:
                raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs {r.shape}/{r.dtype}")
            if not torch.isfinite(g.float()).all():
                raise AssertionError(f"{name} ({tag}): non-finite values from the kernel")
            errs[name] = float((g.float() - r.float()).abs().max())
        if pad.any() and float(got[0][pad].float().abs().max()) != 0.0:
            raise AssertionError(f"gru_scan ({tag}): non-zero output past a row's length")
        log(f"  gru_scan[{tag}] {label} T={t} B={b} H={h} reverse={reverse} "
            f"h0={'carried' if carried else 'zero'}: max|err| "
            + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()) + f" (atol {GRU_ATOL})")
        if not max(errs.values()) <= GRU_ATOL:
            raise AssertionError(f"gru_scan ({tag}) disagrees with its plain version: "
                                 f"{max(errs.values())}")
        all_errs[tag] = errs
        del got
    walked = max(1, min(t, max(lengths)))
    res = {"label": label,
           "shape": {"T": t, "B": b, "H": h, "reverse": reverse, "carried_h0": carried,
                     "steps_walked": walked},
           "max_abs_err": max(max(e.values()) for e in all_errs.values()),
           "errs": all_errs, "atol": GRU_ATOL,
           "plan": {"units": planned.units, "grid": planned.grid,
                    "product": planned.product, "row_groups": planned.row_groups,
                    "k_splits": planned.k_splits, "stages": planned.stages,
                    "chunk_depth": planned.chunk_depth, "smem_bytes": planned.smem_bytes}}
    if timed:
        # step, persistent, persistent, step: both designs on one card in one run
        step_a = time_ms(runs["step"], iters=3)
        res["ms"] = 0.5 * (time_ms(runs["persistent"], iters=5)
                           + time_ms(runs["persistent"], iters=5))
        res["step_design_ms"] = 0.5 * (step_a + time_ms(runs["step"], iters=3))
        res["design"] = "persistent"
        res["recurrence_ms"] = kernel_ms(
            device_ms_by_kernel(runs["persistent"], need="gru_scan_persist_kernel"),
            "gru_scan_persist_kernel")
        res["step_ms"] = res["recurrence_ms"] / walked
        res["plain_ms"] = time_ms(lambda: gru_cuda.gru_scan_plain(*args, reverse=reverse),
                                  iters=2)
        # cuDNN's GRU(D=H, H) on (T, B, H): it also computes the input
        # projection, which gru_scan takes precomputed
        gru = torch.nn.GRU(h, h).to(dev, torch.bfloat16)
        gru.flatten_parameters()
        x = torch.randn(t, b, h, generator=gen, device=dev).to(torch.bfloat16)
        with torch.no_grad():
            res["library_ms"] = time_ms(lambda: gru(x), iters=5)
        del gru, x
        # the same call in float16, where cuDNN's weights are one block
        res["library_fp16_ms"] = cudnn_rnn_ms(torch.nn.GRU(h, h), gen, t, b, h,
                                              backward=False, dtype=torch.float16)
        res["bound_ms"], res["bound_by"] = scan_bound(lengths, t, b, h)
        log(f"    persistent ms={res['ms']:.3f} (kernel {res['recurrence_ms']:.3f} = "
            f"{res['step_ms'] * 1e3:.2f} us a step over {walked}) step-design ms="
            f"{res['step_design_ms']:.3f} plain_ms={res['plain_ms']:.3f} "
            f"library_ms(cuDNN nn.GRU({h},{h}) bf16, with its projection)="
            f"{res['library_ms']:.3f} (float16: {res['library_fp16_ms']:.3f}) "
            f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']})")
    del args, ref
    torch.cuda.empty_cache()
    return res


# the valid steps of a steady streaming chunk: 39 new spectrogram frames
# (6240 samples) + the 10-column cache -> 25 after conv1 -> 35 after the
# conv2 cache, of phys_rnn_frames(64, is_first=False) = 55 physical frames
STREAM_T, STREAM_VALID = 55, 35


def phase_scan_kernels():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    checks = []
    # B = 1 and B = 5 (the product on the CUDA cores), H % 64 != 0
    for lengths in ([13], [13, 1, 7, 12, 3]):
        for reverse in (False, True):
            checks.append(check_scan(gen, "small", 13, lengths, 72, reverse, carried=True,
                                     timed=len(lengths) == 5 and not reverse))
    # H no multiple of 8 (element copies, scalar epilogue), a row of length 0
    checks.append(check_scan(gen, "small H=100", 9, [9, 0, 4], 100, True, carried=True,
                             timed=False))
    # B above 128: two row blocks over the resident slice
    checks.append(check_scan(gen, "small B=150", 7, [7, 1] + [1 + (i % 7) for i in range(148)],
                             72, False, carried=False, timed=False))
    rng = np.random.default_rng(2000)
    lengths = rng.integers(1, 402, size=128)
    lengths[0], lengths[1] = 401, 1
    checks.append(check_scan(gen, "uni batch layer", 401, lengths.tolist(), 2000,
                             False, carried=False, timed=True))
    train = np.random.default_rng(2001).integers(1, 402, size=32)
    train[0] = 401
    checks.append(check_scan(gen, "uni train layer", 401, train.tolist(), 2000,
                             False, carried=False, timed=False))
    checks.append(check_scan(gen, "streaming step", STREAM_T, [STREAM_VALID], 2000,
                             False, carried=True, timed=True))
    # the widest batch of the CUDA-core product (eight streams stepped together)
    checks.append(check_scan(gen, "streaming B=8", STREAM_T,
                             [STREAM_VALID, 20, STREAM_VALID, 1, STREAM_VALID, 0, 12, 34],
                             2000, False, carried=True, timed=False))
    return checks


def compare_outputs(label, names, got, ref, tol):
    """Per-output max |got - ref|, each held to ``tol`` times the larger of
    1 and max |ref| (the GRU outputs are below 1 in magnitude; gradients
    scale with their cotangents). Returns (errs, worst error)."""
    errs = {}
    for name, g, r in zip(names, got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{label} {name}: {g.shape}/{g.dtype} vs "
                                 f"{r.shape}/{r.dtype}")
        if not torch.isfinite(g.float()).all():
            raise AssertionError(f"{label} {name}: non-finite values from the kernel")
        err = float((g.float() - r.float()).abs().max())
        scale = max(1.0, float(r.float().abs().max()))
        errs[name] = err
        if not err <= tol * scale:
            raise AssertionError(f"{label} {name} disagrees with its plain version: "
                                 f"{err} > {tol} x {scale}")
    return errs, max(errs.values())


def scan_bidi_bound(lengths, t, b, h):
    """(bound_ms, bound_by) of one gru_scan_bidi call: two chains' worth of
    :func:`scan_bound`'s operations and bytes."""
    valid = int(sum(lengths))
    flops = 2 * 2 * valid * h * 3 * h
    nbytes = 2 * (valid * 3 * h * 2 + h * 3 * h * 2 + 2 * 3 * h * 4
                  + t * b * h * 2 + 2 * b * h * 4) + b * 4
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def check_scan_bidi(gen, label, t, lengths, h, carried, timed):
    """gru_scan_bidi in both designs against its plain version. The plan
    must choose the persistent design: both chains in one launch where the
    plan for two chains fits, else one launch a chain (H = 2000)."""
    from danspeech_tpu_torch.ops import gru_cuda

    dev = "cuda"
    b = len(lengths)
    bound = 1.0 / h ** 0.5

    def uni(*shape):
        return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * bound

    gx = [(torch.randn(t, b, 3 * h, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
          for _ in range(2)]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    w_hh = [uni(h, 3 * h).to(torch.bfloat16) for _ in range(2)]
    b_ih = [uni(3 * h) for _ in range(2)]
    b_hh = [uni(3 * h) for _ in range(2)]
    h0 = [torch.zeros(b, h, device=dev) for _ in range(2)]
    if carried:
        h0 = [torch.rand(b, h, generator=gen, device=dev) - 0.5 for _ in range(2)]
    args = (*gx, lens, *w_hh, *b_ih, *b_hh, *h0)
    pair, single = gru_cuda.scan_bidi_plans(h, b, lens.device)
    if single.design != "persistent":
        raise AssertionError(f"gru_scan_bidi H={h} B={b}: planned {single}")
    planned = pair if pair.design == "persistent" else single
    layout = "both chains, one launch" if planned is pair else "one launch a chain"
    ref = gru_cuda.gru_scan_bidi_plain(*args)
    torch.cuda.synchronize()
    name = f"gru_scan_bidi {label}"
    pad = torch.arange(t, device=dev)[:, None] >= lens[None, :].long()
    runs = {d: (lambda d=d: gru_cuda.gru_scan_bidi(*args, design=d)) for d in DESIGNS}
    all_errs = {}
    for tag, run in runs.items():
        got = run()
        torch.cuda.synchronize()
        errs, _ = compare_outputs(f"{name} [{tag}]", ("out_f", "out_b", "h_last_f", "h_last_b"),
                                  got, ref, GRU_ATOL)
        for g in got[:2]:
            if pad.any() and float(g[pad].float().abs().max()) != 0.0:
                raise AssertionError(f"{name} [{tag}]: non-zero output past a row's length")
        log(f"  {name} [{tag}{', ' + layout if tag == 'persistent' else ''}] T={t} B={b} "
            f"H={h} h0={'carried' if carried else 'zero'}: max|err| "
            + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()) + f" (atol {GRU_ATOL})")
        all_errs[tag] = errs
        del got
    walked = max(1, min(t, max(lengths)))
    res = {"label": label,
           "shape": {"T": t, "B": b, "H": h, "carried_h0": carried, "steps_walked": walked},
           "max_abs_err": max(max(e.values()) for e in all_errs.values()),
           "errs": all_errs, "atol": GRU_ATOL,
           "plan": {"pair": pair.design, "units": planned.units, "grid": planned.grid,
                    "product": planned.product, "row_groups": planned.row_groups,
                    "stages": planned.stages, "chunk_depth": planned.chunk_depth,
                    "smem_bytes": planned.smem_bytes}}
    if timed:
        # step, persistent, persistent, step: both designs on one card in one run
        step_a = time_ms(runs["step"], iters=3)
        res["ms"] = 0.5 * (time_ms(runs["persistent"], iters=5)
                           + time_ms(runs["persistent"], iters=5))
        res["step_design_ms"] = 0.5 * (step_a + time_ms(runs["step"], iters=3))
        res["design"] = "persistent"
        res["recurrence_ms"] = kernel_ms(
            device_ms_by_kernel(runs["persistent"], need="gru_scan_persist_kernel"),
            "gru_scan_persist_kernel")
        res["step_ms"] = res["recurrence_ms"] / walked
        res["plain_ms"] = time_ms(lambda: gru_cuda.gru_scan_bidi_plain(*args), iters=1)
        # cuDNN's bidirectional GRU(D=H, H): it also computes the input
        # projections, which gru_scan_bidi takes precomputed
        gru = torch.nn.GRU(h, h, bidirectional=True).to(dev, torch.bfloat16)
        gru.flatten_parameters()
        x = torch.randn(t, b, h, generator=gen, device=dev).to(torch.bfloat16)
        with torch.no_grad():
            res["library_ms"] = time_ms(lambda: gru(x), iters=3)
        del gru, x
        res["library_fp16_ms"] = cudnn_rnn_ms(
            torch.nn.GRU(h, h, bidirectional=True), gen, t, b, h, backward=False,
            dtype=torch.float16)
        res["bound_ms"], res["bound_by"] = scan_bidi_bound(lengths, t, b, h)
        log(f"    persistent ms={res['ms']:.3f} ({layout}: kernel "
            f"{res['recurrence_ms']:.3f} = {res['step_ms'] * 1e3:.2f} us a step over "
            f"{walked}) step-design ms={res['step_design_ms']:.3f} "
            f"plain_ms={res['plain_ms']:.3f} library_ms(cuDNN bidirectional "
            f"nn.GRU({h},{h}) bf16, with its projections)={res['library_ms']:.3f} "
            f"(float16: {res['library_fp16_ms']:.3f}) bound_ms={res['bound_ms']:.4f} "
            f"({res['bound_by']})")
    del args, ref
    torch.cuda.empty_cache()
    return res


def phase_scan_bidi_kernels():
    """gru_scan_bidi: B = 1 and B = 5 (the product on the CUDA cores) with a
    carried h0, H no multiple of 8 with an empty row, B above 128, the bidi
    batch layer (T = 401, B = 128, H = 1200: both chains in one launch) and
    H = 2000 (a pair does not fit: one launch a chain)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    checks = [check_scan_bidi(gen, "small", 13, lengths, 72, carried=True,
                              timed=len(lengths) == 5)
              for lengths in ([13], [13, 1, 7, 12, 3])]
    checks.append(check_scan_bidi(gen, "small H=100", 9, [9, 0, 4], 100, carried=True,
                                  timed=False))
    checks.append(check_scan_bidi(gen, "small B=150", 7,
                                  [7, 1] + [1 + (i % 7) for i in range(148)], 72,
                                  carried=True, timed=False))
    rng = np.random.default_rng(1200)
    lengths = rng.integers(1, 402, size=128)
    lengths[0], lengths[1] = 401, 1
    checks.append(check_scan_bidi(gen, "bidi batch layer", 401, lengths.tolist(), 1200,
                                  carried=False, timed=True))
    wide = np.random.default_rng(2002).integers(1, 402, size=32)
    wide[0] = 401
    checks.append(check_scan_bidi(gen, "H=2000, one launch a chain", 401, wide.tolist(),
                                  2000, carried=True, timed=True))
    return checks


# the backward walk against its plain version: the same bf16-rounded
# operands and f32 accumulation, so they differ by summation order, which
# can flip the bf16 rounding of one dgh element (2^-8 of its value) and
# carry on through the walk: allow 2e-2 of the largest reference value
BWD_TOL = 2e-2


def bwd_bound(lengths, t, b, h):
    """(bound_ms, bound_by) of one gru_bwd_scan call: two (H x 3H) products
    per valid step over the bf16 peak, against the bytes (gx, hprev and dout
    of the valid steps and w_hh read once, dgx and dghn written once) over
    the memory rate."""
    valid = int(sum(lengths))
    flops = 2 * 2 * valid * h * 3 * h
    nbytes = (
        valid * (3 * h * 2 + h * 2 + h * 4)   # gx, hprev bf16, dout f32
        + h * 3 * h * 2                       # w_hh bf16
        + 2 * 3 * h * 4 + b * 4               # b_ih, b_hh f32, lengths int32
        + t * b * 4 * h * 4                   # dgx, dghn f32
        + 2 * b * h * 4                       # dh_last, dh0 f32
    )
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def cudnn_rnn_ms(module, gen, t, b, h, backward: bool, dtype=torch.bfloat16):
    """One cuDNN recurrent module (nn.GRU, nn.LSTM or nn.RNN of (H, H)) in
    ``dtype`` at (T, B, H): the time of its forward, or with ``backward`` the
    time of forward plus backward less the time of the forward alone. It
    also computes the input projection, and its backward the weight and
    input gradients, which the port's kernels leave to their caller.

    cuDNN wants its weights in one block. ``flatten_parameters`` makes that
    block for float16 but leaves bf16 weights apart (PyTorch's
    ``cudnn.is_acceptable`` refuses the dtype), so a bf16 call compacts them
    every time and warns: the bf16 time is an upper bound of the library's."""
    rnn = module.to("cuda", dtype)
    rnn.flatten_parameters()
    x = torch.randn(t, b, h, generator=gen, device="cuda").to(dtype)
    if not backward:
        with torch.no_grad():
            return time_ms(lambda: rnn(x), iters=3)
    x.requires_grad_(True)
    dout = torch.randn(t, b, h, generator=gen, device="cuda").to(dtype)

    def fwd_bwd():
        rnn(x)[0].backward(dout)

    both = time_ms(fwd_bwd, iters=3)
    fwd = time_ms(lambda: rnn(x), iters=3)
    return max(both - fwd, 0.0)


def bwd_inputs(gen, t, lengths, h, lens=None):
    dev = "cuda"
    b = len(lengths)
    bound = 1.0 / h ** 0.5

    def uni(*shape):
        return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * bound

    gx = (torch.randn(t, b, 3 * h, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    hprev = (torch.rand(t, b, h, generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    dout = torch.randn(t, b, h, generator=gen, device=dev)
    if lens is None:
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    w_hh = uni(h, 3 * h).to(torch.bfloat16)
    b_ih, b_hh = uni(3 * h), uni(3 * h)
    dh_last = torch.randn(b, h, generator=gen, device=dev)
    return (gx, hprev, dout, lens, w_hh, b_ih, b_hh, dh_last)


def check_bwd(gen, label, t, lengths, h, reverse, timed, pair=True):
    """gru_bwd_scan in both designs, and gru_bwd_scan_pair (two chains in one
    persistent launch where the plan allows), against the plain version; the
    plan must choose the persistent design at this shape."""
    from danspeech_tpu_torch.ops import gru_cuda, persist_plan

    dev = "cuda"
    b = len(lengths)
    args = bwd_inputs(gen, t, lengths, h)
    lens = args[3]
    dev_info = gru_cuda.device_info(args[0].device)
    planned = persist_plan.plan_gru_backward(h, b, 1, *dev_info)
    if planned.design != "persistent":
        raise AssertionError(f"gru_bwd_scan H={h} B={b}: planned {planned}")
    ref = gru_cuda.gru_bwd_scan_plain(*args, reverse=reverse)
    torch.cuda.synchronize()
    name = f"gru_bwd_scan {label}"
    pad = torch.arange(t, device=dev)[:, None] >= lens[None, :].long()
    max_ref = {k: float(r.abs().max()) for k, r in zip(("dgx", "dghn", "dh0"), ref)}

    def hold(tag, got, want):
        errs, err = compare_outputs(f"{name} [{tag}]", ("dgx", "dghn", "dh0"), got, want,
                                    BWD_TOL)
        for g in got[:2]:
            if pad.any() and float(g[pad].abs().max()) != 0.0:
                raise AssertionError(f"{name} [{tag}]: non-zero gradient past a row's length")
        log(f"  {name} [{tag}] T={t} B={b} H={h} reverse={reverse}: max|err| "
            + ", ".join(f"{k}={v:.3e} (max|ref| {max_ref[k]:.2f})" for k, v in errs.items())
            + f" (tol {BWD_TOL} x max(1, max|ref|))")
        return errs, err

    all_errs, worst = {}, 0.0
    for design in DESIGNS:
        got = gru_cuda.gru_bwd_scan(*args, reverse=reverse, design=design)
        torch.cuda.synchronize()
        all_errs[design], err = hold(design, got, ref)
        worst = max(worst, err)
        del got
    pair_plan = persist_plan.plan_gru_backward(h, b, 2, *dev_info)
    other = ref_b = None
    if pair:
        # a second chain walking the other way over the same lengths
        other = bwd_inputs(gen, t, lengths, h, lens=lens)
        ref_b = gru_cuda.gru_bwd_scan_plain(*other, reverse=not reverse)
        before = gru_cuda.gru_bwd_scan.launches
        got_a, got_b = gru_cuda.gru_bwd_scan_pair(args, other, reverse, not reverse)
        torch.cuda.synchronize()
        if gru_cuda.gru_bwd_scan.launches != before + 2:
            raise AssertionError(f"{name}: a pair must count two chains")
        tag = "pair, one launch" if pair_plan.design == "persistent" else "pair, two launches"
        all_errs["pair a"], err_a = hold(tag + ", chain a", got_a, ref)
        max_ref = {k: float(r.abs().max()) for k, r in zip(("dgx", "dghn", "dh0"), ref_b)}
        all_errs["pair b"], err_b = hold(tag + ", chain b", got_b, ref_b)
        worst = max(worst, err_a, err_b)
        del got_a, got_b
    res = {"label": label, "shape": {"T": t, "B": b, "H": h, "reverse": reverse},
           "max_abs_err": worst, "errs": all_errs, "tol": BWD_TOL,
           "max_abs_ref": {k: float(r.abs().max()) for k, r in zip(("dgx", "dghn", "dh0"), ref)},
           "plan": {"units": planned.units, "grid": planned.grid, "row_groups": planned.row_groups,
                    "k_splits": planned.k_splits, "stages": planned.stages,
                 "chunk_depth": planned.chunk_depth,
                    "smem_bytes": planned.smem_bytes, "pair": pair_plan.design}}
    if timed:
        def run(design):
            return lambda: gru_cuda.gru_bwd_scan(*args, reverse=reverse, design=design)

        # step, persistent, persistent, step: both designs on one card in one run
        step_a = time_ms(run("step"), iters=3)
        res["ms"] = 0.5 * (time_ms(run("persistent"), iters=5)
                           + time_ms(run("persistent"), iters=5))
        res["step_design_ms"] = 0.5 * (step_a + time_ms(run("step"), iters=3))
        res["design"] = "persistent"
        split = device_ms_by_kernel(run("persistent"), need="gru_bwd_persist_kernel")
        res["walk_ms"] = kernel_ms(split, "gru_bwd_persist_kernel")
        res["recompute_ms"] = (kernel_ms(split, "gru_proj_wgmma_kernel")
                               + kernel_ms(split, "gru_proj_kernel"))
        res["step_ms"] = res["walk_ms"] / (t + 1)
        res["recompute_tflops"] = 2 * t * b * h * 3 * h / max(res["recompute_ms"], 1e-9) / 1e9
        if pair:
            res["pair_ms_per_chain"] = 0.5 * time_ms(
                lambda: gru_cuda.gru_bwd_scan_pair(args, other, reverse, not reverse), iters=5)
        res["plain_ms"] = time_ms(
            lambda: gru_cuda.gru_bwd_scan_plain(*args, reverse=reverse), iters=1)
        res["library_ms"] = cudnn_rnn_ms(torch.nn.GRU(h, h), gen, t, b, h, backward=True)
        res["library_fp16_ms"] = cudnn_rnn_ms(torch.nn.GRU(h, h), gen, t, b, h,
                                              backward=True, dtype=torch.float16)
        res["bound_ms"], res["bound_by"] = bwd_bound(lengths, t, b, h)
        log(f"    persistent ms={res['ms']:.3f} (walk {res['walk_ms']:.3f} = "
            f"{res['step_ms'] * 1e3:.2f} us a step, recompute {res['recompute_ms']:.3f} = "
            f"{res['recompute_tflops']:.0f} TFLOP/s"
            + (f"; as a pair [{pair_plan.design}] {res['pair_ms_per_chain']:.3f} a chain"
               if pair else "")
            + f") step-design ms={res['step_design_ms']:.3f} plain_ms={res['plain_ms']:.3f} "
            f"library_ms(cuDNN nn.GRU({h},{h}) bf16 forward+backward less forward)="
            f"{res['library_ms']:.3f} (float16: {res['library_fp16_ms']:.3f}) "
            f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']})")
    del args, ref, other, ref_b
    torch.cuda.empty_cache()
    return res


def phase_bwd_kernels():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    checks = [check_bwd(gen, "small", 13, [13, 0, 1, 7, 12], 72, reverse, timed=reverse)
              for reverse in (True, False)]
    checks.append(check_bwd(gen, "small T=1", 1, [1, 0], 72, True, timed=False))
    # H no multiple of 8 (scalar load paths), a lone row
    checks.append(check_bwd(gen, "small H=100", 9, [9, 1, 4], 100, True, timed=False))
    checks.append(check_bwd(gen, "small B=1", 11, [11], 64, False, timed=False))
    # B above 128: two row blocks over the same resident slice
    checks.append(check_bwd(gen, "small B=150", 7, [7, 0] + [1 + (i % 7) for i in range(148)],
                            72, True, timed=False))
    for label, h in (("flagship layer", 1200), ("uni layer", 2000)):
        rng = np.random.default_rng(h + 1)
        lengths = rng.integers(1, 402, size=32)
        lengths[0], lengths[1] = 401, 1
        checks.append(check_bwd(gen, label, 401, lengths.tolist(), h, True, timed=True))
        checks.append(check_bwd(gen, f"{label}, forward walk", 401, lengths.tolist(), h,
                                False, timed=False, pair=False))
    return checks


# ---------------------------------------------------------------------------
# Phase 3, LSTM and tanh-RNN kernels
# ---------------------------------------------------------------------------


def rnn_kernel_bound(kind, lengths, t, b, h):
    """(bound_ms, bound_by) of one call of an LSTM or tanh-RNN kernel: the
    operations of the valid steps over the bf16 peak against the bytes (the
    input streams of the valid steps and the weights read once, the output
    streams and final states written once) over the memory rate."""
    valid = int(sum(lengths))
    gates = 4 if kind.startswith("lstm") else 1
    # the LSTM walk recomputes its gates; tanh' comes off the stored stream
    products = 2 if kind == "lstm_bwd_scan" else 1
    flops = 2 * products * valid * h * gates * h
    nbytes = h * gates * h * 2 + b * 4           # w_hh bf16, lengths int32
    if kind in ("lstm_scan", "lstm_scan_with_cell"):
        nbytes += valid * 4 * h * 2 + 4 * h * 4  # gx bf16, b_hh f32
        nbytes += t * b * h * 2 * (2 if kind == "lstm_scan_with_cell" else 1)
        nbytes += 4 * b * h * 4                  # h0, c0, h_last, c_last f32
    elif kind == "lstm_bwd_scan":
        nbytes += valid * (4 * h * 2 + 2 * h * 2 + h * 4)  # gx, hprev, cprev, dout
        nbytes += 4 * h * 4 + t * b * 4 * h * 4 + 2 * b * h * 4  # b_hh, dg4, dh0, dc0
    elif kind == "rnn_tanh_scan":
        nbytes += valid * h * 2 + t * b * h * 2 + b * h * 4      # gx, out, h_last
    else:
        nbytes += valid * (h * 2 + h * 4) + t * b * h * 4 + b * h * 4  # out, dout, dpre, dh0
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def lstm_inputs(gen, t, lengths, h, lens=None):
    """Seeded operands of one LSTM chain: (gx, lengths, w_hh, b_hh, h0, c0),
    h0 and c0 carried; ``lens`` shares another chain's lengths tensor."""
    dev = "cuda"
    b = len(lengths)
    bound = 1.0 / h ** 0.5

    def uni(*shape):
        return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * bound

    if lens is None:
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    gx = (torch.randn(t, b, 4 * h, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    carried = [torch.rand(b, h, generator=gen, device=dev) - 0.5 for _ in range(2)]
    return (gx, lens, uni(h, 4 * h).to(torch.bfloat16), uni(4 * h), *carried)


# the persistent kernel of each LSTM and tanh-RNN wrapper, as the profiler names it
PERSIST_KERNELS = {"lstm_scan": "lstm_persist_kernel",
                   "lstm_scan_with_cell": "lstm_persist_kernel",
                   "lstm_bwd_scan": "lstm_bwd_persist_kernel",
                   "rnn_tanh_scan": "rnn_tanh_persist_kernel",
                   "rnn_tanh_bwd_scan": "rnn_tanh_bwd_persist_kernel"}


def check_rnn_kernel(kind, gen, label, t, lengths, h, reverse, timed):
    """One LSTM or tanh-RNN kernel against its plain version on the card.
    Forward kernels are held to GRU_ATOL and backward walks to BWD_TOL, each
    times the larger of 1 and the largest reference value. Each kernel is
    checked in both designs and as a pair of chains in one launch
    (lstm_scan_pair, lstm_bwd_scan_pair, rnn_tanh_scan_pair,
    rnn_tanh_bwd_scan_pair; the second chain walks the other way); the plan
    must choose the persistent design for one chain and for two."""
    from danspeech_tpu_torch.ops import gru_cuda, lstm_cuda, persist_plan, rnn_tanh_cuda

    dev = "cuda"
    b = len(lengths)
    bound = 1.0 / h ** 0.5
    lstm = kind.startswith("lstm")
    lstm_fwd = kind in ("lstm_scan", "lstm_scan_with_cell")
    lstm_bwd = kind == "lstm_bwd_scan"
    gates = 4 if lstm else 1
    module = lstm_cuda if lstm else rnn_tanh_cuda
    wrapper, plain = getattr(module, kind), getattr(module, f"{kind}_plain")

    def uni(*shape):
        return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * bound

    def stream(width, scale=0.5):
        return (torch.randn(t, b, width, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    pad = torch.arange(t, device=dev)[:, None] >= lens[None, :].long()
    backward = kind.endswith("bwd_scan")

    w_hh = None if lstm_fwd else uni(h, gates * h).to(torch.bfloat16)
    if lstm_fwd:
        args = lstm_inputs(gen, t, lengths, h, lens)
        names = (("out", "c_seq", "h_last", "c_last") if kind == "lstm_scan_with_cell"
                 else ("out", "h_last", "c_last"))
        n_streams = len(names) - 2
    elif lstm_bwd:
        def walk_operands(w):
            hprev = (torch.rand(t, b, h, generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
            return (stream(4 * h), hprev, stream(h, 1.0),
                    torch.randn(t, b, h, generator=gen, device=dev), lens, w, uni(4 * h))

        args = walk_operands(w_hh)
        names, n_streams = ("dg4", "dh0", "dc0"), 1
    elif kind == "rnn_tanh_scan":
        def tanh_operands(w):
            return (stream(h), lens, w)

        args = tanh_operands(w_hh)
        names, n_streams = ("out", "h_last"), 1
    else:
        def tanh_walk_operands(w):
            out = (torch.rand(t, b, h, generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
            out[pad] = 0  # the forward stream is zero past a row's length
            return (out, torch.randn(t, b, h, generator=gen, device=dev), lens, w)

        args = tanh_walk_operands(w_hh)
        names, n_streams = ("dpre", "dh0"), 1
    ref = plain(*args, reverse=reverse)
    torch.cuda.synchronize()
    tol = BWD_TOL if backward else GRU_ATOL
    name = f"{kind} {label}"

    def hold(tag, got, want):
        errs, err = compare_outputs(f"{name} [{tag}]", names, got, want, tol)
        for g in got[:n_streams]:
            if pad.any() and float(g[pad].float().abs().max()) != 0.0:
                raise AssertionError(f"{name} [{tag}]: non-zero values past a row's length")
        log(f"  {name} [{tag}] T={t} B={b} H={h} reverse={reverse}: max|err| "
            + ", ".join(f"{k}={v:.3e} (max|ref| {float(r.float().abs().max()):.2f})"
                        for (k, v), r in zip(errs.items(), want))
            + f" (tol {tol} x max(1, max|ref|))")
        return errs, err

    dev_info = gru_cuda.device_info(lens.device)
    plan_fn = {"lstm_scan": persist_plan.plan_lstm_forward,
               "lstm_scan_with_cell": persist_plan.plan_lstm_forward,
               "lstm_bwd_scan": persist_plan.plan_lstm_backward,
               "rnn_tanh_scan": persist_plan.plan_rnn_tanh_forward,
               "rnn_tanh_bwd_scan": persist_plan.plan_rnn_tanh_backward}[kind]
    planned = plan_fn(h, b, 1, *dev_info)
    pair_plan = plan_fn(h, b, 2, *dev_info)
    if planned.design != "persistent" or pair_plan.design != "persistent":
        raise AssertionError(f"{kind} H={h} B={b}: planned {planned}, pair {pair_plan}")
    runs = {d: (lambda d=d: wrapper(*args, reverse=reverse, design=d)) for d in DESIGNS}
    # a second chain walking the other way over the same lengths
    if lstm_bwd:
        other = walk_operands(uni(h, 4 * h).to(torch.bfloat16))
        runs["pair"] = lambda: lstm_cuda.lstm_bwd_scan_pair(args, other, reverse, not reverse)
    elif lstm_fwd:
        other = lstm_inputs(gen, t, lengths, h, lens)
        with_cell = kind == "lstm_scan_with_cell"
        runs["pair"] = lambda: lstm_cuda.lstm_scan_pair(args, other, reverse, not reverse,
                                                        with_cell=with_cell)
    elif kind == "rnn_tanh_scan":
        other = tanh_operands(uni(h, h).to(torch.bfloat16))
        runs["pair"] = lambda: rnn_tanh_cuda.rnn_tanh_scan_pair(args, other, reverse,
                                                                not reverse)
    else:
        other = tanh_walk_operands(uni(h, h).to(torch.bfloat16))
        runs["pair"] = lambda: rnn_tanh_cuda.rnn_tanh_bwd_scan_pair(args, other, reverse,
                                                                    not reverse)
    ref_b = plain(*other, reverse=not reverse)
    # the wrappers with a count of paired launches count chains, lstm_scan and
    # lstm_scan_with_cell count launches
    counts_chains = hasattr(wrapper, "pair_launches")
    all_errs, worst = {}, 0.0
    for tag, run in runs.items():
        before = wrapper.launches
        pairs_before = getattr(wrapper, "pair_launches", 0)
        got = run()
        torch.cuda.synchronize()
        if tag == "pair":
            if counts_chains and (wrapper.launches != before + 2
                                  or wrapper.pair_launches != pairs_before + 1):
                raise AssertionError(f"{name}: a pair must be one launch of two chains")
            if not counts_chains and wrapper.launches != before + 1:
                raise AssertionError(f"{name}: a pair must be one launch")
            all_errs["pair a"], err_a = hold("pair, one launch, chain a", got[0], ref)
            all_errs["pair b"], err_b = hold("pair, one launch, chain b", got[1], ref_b)
            worst = max(worst, err_a, err_b)
        else:
            all_errs[tag], err = hold(tag, got, ref)
            worst = max(worst, err)
        del got
    res = {"label": label, "shape": {"T": t, "B": b, "H": h, "reverse": reverse},
           "max_abs_err": worst, "errs": all_errs, "tol": tol,
           "max_abs_ref": {k: float(r.float().abs().max()) for k, r in zip(names, ref)}}
    res["plan"] = {"units": planned.units, "grid": planned.grid,
                   "row_groups": planned.row_groups, "stages": planned.stages,
                   "chunk_depth": planned.chunk_depth, "pair_units": pair_plan.units,
                   "pair_grid": pair_plan.grid, "pair_stages": pair_plan.stages}
    if timed:
        # step, persistent, pair, persistent, step: one card, one run
        step_a = time_ms(runs["step"], iters=3)
        first = time_ms(runs["persistent"], iters=5)
        res["pair_ms_per_chain"] = 0.5 * time_ms(runs["pair"], iters=5)
        res["ms"] = 0.5 * (first + time_ms(runs["persistent"], iters=5))
        res["step_design_ms"] = 0.5 * (step_a + time_ms(runs["step"], iters=3))
        res["design"] = "persistent"
        kernel = PERSIST_KERNELS[kind]
        split = device_ms_by_kernel(runs["persistent"], need=kernel)
        res["pair_kernel_ms"] = kernel_ms(device_ms_by_kernel(runs["pair"], need=kernel), kernel)
        if backward:
            # the walks take T + 1 steps, the last one only finishes dh0
            res["walk_ms"] = kernel_ms(split, kernel)
            res["step_ms"] = res["walk_ms"] / (t + 1)
            extra = (f" (walk {res['walk_ms']:.3f} = {res['step_ms'] * 1e3:.2f} us a step "
                     f"over {t + 1}")
            if lstm_bwd:
                res["recompute_ms"] = (kernel_ms(split, "gru_proj_wgmma_kernel")
                                       + kernel_ms(split, "gru_proj_kernel"))
                res["recompute_tflops"] = (2 * t * b * h * 4 * h
                                           / max(res["recompute_ms"], 1e-9) / 1e9)
                extra += (f", recompute {res['recompute_ms']:.3f} = "
                          f"{res['recompute_tflops']:.0f} TFLOP/s")
            extra += f"; as a pair {res['pair_ms_per_chain']:.3f} a chain, walk "
        else:
            # the forward chains walk only the steps before the longest length
            walked = max(1, min(t, max(lengths)))
            res["recurrence_ms"] = kernel_ms(split, kernel)
            res["step_ms"] = res["recurrence_ms"] / walked
            extra = (f" (kernel {res['recurrence_ms']:.3f} = {res['step_ms'] * 1e3:.2f} us a "
                     f"step over {walked}; as a pair {res['pair_ms_per_chain']:.3f} a chain, "
                     "kernel ")
        extra += (f"{res['pair_kernel_ms']:.3f} for both) step-design ms="
                  f"{res['step_design_ms']:.3f}")
        res["plain_ms"] = time_ms(lambda: plain(*args, reverse=reverse), iters=1)

        def lib():
            return torch.nn.LSTM(h, h) if lstm else torch.nn.RNN(h, h, nonlinearity="tanh")

        res["library_ms"] = cudnn_rnn_ms(lib(), gen, t, b, h, backward=backward)
        # the same call in float16, where cuDNN's weights are one block
        res["library_fp16_ms"] = cudnn_rnn_ms(lib(), gen, t, b, h, backward=backward,
                                              dtype=torch.float16)
        res["bound_ms"], res["bound_by"] = rnn_kernel_bound(kind, lengths, t, b, h)
        log(f"    ms={res['ms']:.3f}{extra} plain_ms={res['plain_ms']:.3f} library_ms(cuDNN "
            f"nn.{'LSTM' if lstm else 'RNN'}({h},{h}) bf16, with its projection, "
            + ("forward+backward less forward" if backward else "forward")
            + f")={res['library_ms']:.3f} (float16: {res['library_fp16_ms']:.3f}) "
            f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']})")
    del args, ref, other, ref_b, runs
    torch.cuda.empty_cache()
    return res


def phase_rnn_type_kernels():
    """{kernel: checks} for the three LSTM and two tanh-RNN kernels: ragged
    small shapes (B = 5 with an empty row and B = 1, H = 72, both
    directions, T = 1, H = 100, B = 150), then the layer shapes of
    LSTM5x800 / Tanh5x800: serving (B = 128) and training (B = 32) for the
    forward kernels, training for the backward walks (the LSTM's walking
    both ways)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    serve = np.random.default_rng(800).integers(1, 402, size=128)
    train = np.random.default_rng(801).integers(1, 402, size=32)
    for lengths in (serve, train):
        lengths[0], lengths[1] = 401, 1
    layer_shapes = {
        "lstm_scan": [("serve layer", serve), ("train-size layer", train)],
        "lstm_scan_with_cell": [("train layer", train), ("serve-size layer", serve)],
        "lstm_bwd_scan": [("train layer", train)],
        "rnn_tanh_scan": [("serve layer", serve), ("train layer", train)],
        "rnn_tanh_bwd_scan": [("train layer", train)],
    }
    checks = {}
    for kind, shapes in layer_shapes.items():
        forward_chain = not kind.endswith("bwd_scan")
        rows = []
        for lengths in ([13, 0, 1, 7, 12], [13]):
            for reverse in (False, True):
                # time the small shape once, in the direction of a forward chain
                timed = len(lengths) == 5 and reverse != forward_chain
                rows.append(check_rnn_kernel(kind, gen, "small", 13, lengths, 72,
                                             reverse, timed))
        rows.append(check_rnn_kernel(kind, gen, "small T=1", 1, [1, 0], 72,
                                     not forward_chain, False))
        # H no multiple of 8 (element copies of the left operand); B above
        # 128 (two row blocks over the resident slices)
        rows.append(check_rnn_kernel(kind, gen, "small H=100", 9, [9, 0, 4], 100,
                                     not forward_chain, False))
        rows.append(check_rnn_kernel(kind, gen, "small B=150", 7,
                                     [7, 1] + [1 + (i % 7) for i in range(148)], 72,
                                     not forward_chain, False))
        for label, lengths in shapes:
            rows.append(check_rnn_kernel(kind, gen, label, 401, lengths.tolist(), 800,
                                         not forward_chain, True))
        if kind == "lstm_bwd_scan":
            rows.append(check_rnn_kernel(kind, gen, "train layer, forward walk", 401,
                                         train.tolist(), 800, False, False))
        checks[kind] = rows
    return checks


def phase_gru_layer_routes():
    """gru_layer on the card for the shapes that reach gru_scan_bidi:
    concatenated directions, and a carried h0. One call each, in the
    persistent design (both chains in one launch); the result against
    impl="plain" on the card."""
    from danspeech_tpu_torch.ops import gru_cuda
    from danspeech_tpu_torch.ops.rnn import GRUWeights, gru_layer

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    t, b, d, h = 401, 32, 1200, 1200
    rng = np.random.default_rng(4)
    lengths = rng.integers(1, t + 1, size=b)
    lengths[0] = t
    x, lens, wif, wib, whf, whb, bif, bib, bhf, bhb = gru_layer_inputs(
        gen, t, b, d, h, lengths.tolist())
    fwd, bwd = GRUWeights(wif, whf, bif, bhf), GRUWeights(wib, whb, bib, bhb)
    h0 = torch.rand(2, b, h, generator=gen, device="cuda") - 0.5
    out = {}
    gru_cuda.gru_scan_bidi.launches = 0
    zero_designs()
    with torch.no_grad():
        for label, kw in (("concat", dict(sum_directions=False)), ("carried h0", dict(h0=h0))):
            before = gru_cuda.gru_scan_bidi.launches
            got = gru_layer(x.float(), lens, fwd, bwd, **kw)
            torch.cuda.synchronize()
            if gru_cuda.gru_scan_bidi.launches != before + 1:
                raise AssertionError(f"gru_layer({label}) did not launch gru_scan_bidi once")
            ref = gru_layer(x.float(), lens, fwd, bwd, impl="plain", **kw)
            width = h if label == "carried h0" else 2 * h
            if tuple(got[0].shape) != (t, b, width) or tuple(got[1].shape) != (2, b, h):
                raise AssertionError(f"gru_layer({label}): shapes {got[0].shape}, {got[1].shape}")
            # a summed output holds two bf16 roundings
            errs, _ = compare_outputs(f"gru_layer({label})", ("out", "h_last"), got, ref,
                                      2 * GRU_ATOL)
            log(f"  gru_layer({label}) T={t} B={b} D={d} H={h}: one gru_scan_bidi launch, "
                f"max|err| out={errs['out']:.3e} h_last={errs['h_last']:.3e} "
                f"(atol {2 * GRU_ATOL})")
            out[label] = errs
    out["launches"] = gru_cuda.gru_scan_bidi.launches
    require_persistent(gru_cuda.gru_scan_bidi, "gru_layer routes to gru_scan_bidi")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 4: the batch path
# ---------------------------------------------------------------------------

# the flagship on the card against the plain GRU on the card, and a small
# model on the card against the port's CPU path (both bf16): the GRU kernel
# differs from its plain version only by summation order (GRU_ATOL), which
# moves a probability by far less than these bounds; argmax agreement is
# counted over the real rows' valid frames, where a flip needs two classes
# within that error of each other
PROB_ATOL = 2e-2
ARGMAX_AGREEMENT_MIN = 0.97


def compare_probs(label, probs, ref, out_lens, rows):
    probs, ref = probs[:rows].float(), ref[:rows].float()
    valid = (torch.arange(probs.shape[1], device=probs.device)[None, :]
             < out_lens[:rows].to(probs.device).long()[:, None])
    if not torch.isfinite(probs).all():
        raise AssertionError(f"{label}: non-finite probabilities")
    sums = probs.sum(-1)
    if float((sums - 1).abs().max()) > 1e-3:
        raise AssertionError(f"{label}: probabilities do not sum to 1")
    diff = float((probs - ref).abs()[valid].max())
    agree = float((probs.argmax(-1) == ref.argmax(-1))[valid].float().mean())
    log(f"  {label}: max|dprob|={diff:.3e} (<= {PROB_ATOL}), frame argmax "
        f"agreement={agree:.5f} (>= {ARGMAX_AGREEMENT_MIN}) over "
        f"{int(valid.sum())} frames")
    if not (diff <= PROB_ATOL and agree >= ARGMAX_AGREEMENT_MIN):
        raise AssertionError(f"{label}: outside the stated bounds")
    return {"max_abs_prob_err": diff, "argmax_agreement": agree}


def seeded_waveforms(rng, n, lo_s=1.0, hi_s=8.0):
    lens = rng.integers(int(lo_s * 16000), int(hi_s * 16000) + 1, size=n)
    return [
        np.clip(rng.normal(size=k) * 3000.0, -32768, 32767).astype(np.int16)
        for k in lens
    ]


def profile_call(label, fn, top=12, groups=None):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's busy share of the call's wall time. ``groups`` maps a
    label to substrings of kernel names: the device time of each group (a
    kernel counts for the first group that matches) is logged and returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    log(f"  profile of {label}: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    for name, ms, count in rows[:top]:
        log(f"    {ms:9.2f} ms {100 * ms / max(busy_ms, 1e-9):5.1f}% x{count:<6d} {name[:90]}")
    if not rows:
        log("    the profiler saw no device time")
    res = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "top": [{"kernel": n, "ms": ms, "count": c} for n, ms, c in rows[:top]]}
    if groups:
        split = {g: 0.0 for g in groups}
        split["other"] = 0.0
        for name, ms, _ in rows:
            hit = next((g for g, subs in groups.items()
                        if any(sub in name.lower() for sub in subs)), "other")
            split[hit] += ms
        res["split_ms"] = split
        log("    split: " + ", ".join(
            f"{g} {ms:.1f} ms ({100 * ms / max(busy_ms, 1e-9):.1f}%)"
            for g, ms in split.items()))
    return res


def phase_serve(card):
    from danspeech_tpu_torch import Recognizer
    from danspeech_tpu_torch.audio import load_audio_pcm16
    from danspeech_tpu_torch.engine import DanSpeechRecognizer
    from danspeech_tpu_torch.models import DeepSpeechConfig, DeepSpeechModel
    from danspeech_tpu_torch.models.deepspeech import get_seq_lens
    from danspeech_tpu_torch.ops import gru_cuda

    config = DeepSpeechConfig(**FLAGSHIP)
    t0 = time.perf_counter()
    model = DeepSpeechModel.init_random(config, seed=0)
    rec = Recognizer(model=model)  # device=None: CUDA
    eng = rec.danspeech_recognizer
    torch.cuda.synchronize()
    log(f"  flagship {config.rnn_layers}x{config.rnn_hidden_size} bidi GRU, "
        f"{config.conv_layers} conv, {model.get_param_size()} params, "
        f"device {eng.device}, compute {eng.compute_dtype}: set up in "
        f"{time.perf_counter() - t0:.1f} s")
    if eng.device.type != "cuda" or eng.compute_dtype != "bfloat16":
        raise AssertionError("the default engine must run bf16 on CUDA")

    clips = sorted(glob.glob(os.path.join("tests", "data", "clip_*.wav")))
    if not clips:
        raise FileNotFoundError("tests/data/clip_*.wav: run from the repo root")
    clip_audio = [load_audio_pcm16(p) for p in clips]
    rng = np.random.default_rng(0)
    batches = [seeded_waveforms(rng, 128) for _ in range(3)]
    expected = config.rnn_layers * (
        len(clip_audio) + sum(len(eng._plan_groups(b)) for b in batches)
    )

    gru_cuda.gru_bidi_fused.launches = 0
    zero_designs()
    calls = []
    for path, wave in zip(clips, clip_audio):
        t0 = time.perf_counter()
        text = rec.recognize(wave)
        calls.append(("recognize", os.path.basename(path), len(wave),
                      time.perf_counter() - t0))
        if not isinstance(text, str):
            raise AssertionError(f"recognize returned {type(text)}")
    for k, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        texts = rec.recognize_batch(batch)
        calls.append(("recognize_batch", f"batch{k}", sum(len(w) for w in batch),
                      time.perf_counter() - t0))
        if len(texts) != len(batch) or not all(isinstance(t, str) for t in texts):
            raise AssertionError("recognize_batch returned the wrong shape")
    launches = gru_cuda.gru_bidi_fused.launches
    log(f"  gru_bidi_fused launches on the main path: {launches} "
        f"(expected {expected} = {config.rnn_layers} layers x dispatch groups)")
    if launches != expected:
        raise AssertionError("the main path did not run every GRU layer on the kernel")
    require_persistent(gru_cuda.gru_bidi_fused, "flagship serving")
    serve = []
    for kind, what, samples, wall in calls:
        audio_s = samples / 16000.0
        serve.append({"call": kind, "input": what, "audio_s": audio_s,
                      "wall_s": wall, "audio_s_per_s": audio_s / wall})
        log(f"  {kind}({what}): {audio_s:.2f} audio-s in {wall:.3f} s = "
            f"{audio_s / wall:.1f} audio-s/s [{card}]")

    profile = profile_call("one recognize_batch",
                           lambda: rec.recognize_batch(batches[1]),
                           groups=TRAIN_PROFILE_GROUPS)

    # one dispatch group of the first batch, kernel vs plain GRU on the card
    idxs, maxlen = eng._plan_groups(batches[0])[0]
    staged, lengths = eng._stage_group(batches[0], idxs, maxlen)
    wave = staged.to("cuda")
    lens = torch.from_numpy(lengths).to("cuda")
    params = eng._compute_params
    probs, out_lens = eng._forward(params, wave, lens)
    ref, _ = eng._forward(params, wave, lens, rnn_impl="plain")
    torch.cuda.synchronize()
    frames = int(get_seq_lens(config, 1 + maxlen // eng.audio_parser.hop_length))
    if tuple(probs.shape) != (len(lengths), frames, config.num_classes):
        raise AssertionError(f"probs shape {tuple(probs.shape)}, expected "
                             f"{(len(lengths), frames, config.num_classes)}")
    check_flag = compare_probs(
        f"flagship group rows={len(idxs)} bucket={maxlen}: kernel vs plain GRU",
        probs, ref, out_lens, len(idxs))
    del probs, ref, rec, eng, model, params
    torch.cuda.empty_cache()

    # a small model on the card against the port's CPU path
    small = DeepSpeechConfig(model_name="small", rnn_hidden_size=64,
                             rnn_layers=2, conv_layers=3)
    small_model = DeepSpeechModel.init_random(small, seed=1)
    gpu = DanSpeechRecognizer(model_name=small_model)
    cpu = DanSpeechRecognizer(model_name=small_model, device="cpu",
                              compute_dtype="bfloat16")
    waves = seeded_waveforms(np.random.default_rng(1), 6, 0.5, 3.0) + clip_audio
    idxs, maxlen = gpu._plan_groups(waves)[0]
    staged, lengths = gpu._stage_group(waves, idxs, maxlen)
    probs, out_lens = gpu._forward(gpu._compute_params, staged.to("cuda"),
                                   torch.from_numpy(lengths).to("cuda"))
    ref, _ = cpu._forward(cpu._compute_params, staged.clone(),
                          torch.from_numpy(lengths))
    check_small = compare_probs("small model: card vs CPU path", probs.cpu(),
                                ref, out_lens.cpu(), len(idxs))
    return {"launches": launches, "expected_launches": expected,
            "profile": profile,
            "serve": serve, "flagship_vs_plain": check_flag,
            "small_vs_cpu": check_small}


# ---------------------------------------------------------------------------
# Phase 5: the streaming path
# ---------------------------------------------------------------------------

RATE = 16000
MIC_READ = 3200  # samples per microphone read in the documented accumulation


def stream_requirements(context):
    """Samples of the first and of every later streaming chunk: (context-1)*2
    new spectrogram frames per step, and 15 more 10 ms blocks on the first
    for the conv left padding (8640 and 6240 at context 20)."""
    per10ms = RATE // 100
    general = per10ms * 2 + per10ms * ((context - 1) * 2 - 1)
    return general + per10ms * 15, general


def accumulate(wave_f32, context):
    """The documented accumulation: the (chunk, is_first, is_last) calls of
    streaming_transcribe for a waveform read MIC_READ samples at a time."""
    first_req, general_req = stream_requirements(context)
    reads = [wave_f32[i:i + MIC_READ] for i in range(0, len(wave_f32), MIC_READ)]
    calls, acc, first = [], np.zeros(0, np.float32), True
    for k, r in enumerate(reads):
        last = k == len(reads) - 1
        acc = np.concatenate([acc, r])
        if first:
            if len(acc) >= first_req:
                calls.append((acc, True, False))
                acc, first = np.zeros(0, np.float32), False
        elif last or len(acc) >= general_req:
            calls.append((acc, False, last))
            acc = np.zeros(0, np.float32)
    return calls


def record_calls(eng):
    """Record every streaming_transcribe call of ``eng`` as (chunk,
    is_first, is_last) and count its secondary-model runs."""
    calls, secondary = [], []
    cls = type(eng)

    def recorded(recording, is_last, is_first):
        calls.append((np.array(recording, np.float32), is_first, is_last))
        return cls.streaming_transcribe(eng, recording, is_last=is_last,
                                        is_first=is_first)

    def counted(spect):
        secondary.append(spect.shape[1])
        return cls._run_secondary(eng, spect)

    eng.streaming_transcribe, eng._run_secondary = recorded, counted
    return calls, secondary


def frame_steps(calls, audio_config):
    """Replay the chunks through a fresh streaming parser: the (spectrogram,
    is_first, is_last) of every call that yields frames, i.e. that runs the
    device step."""
    from danspeech_tpu_torch.features.spectrogram import InferenceSpectrogramAudioParser

    parser = InferenceSpectrogramAudioParser(audio_config)
    steps = []
    for chunk, first, last in calls:
        spect = parser.parse_audio(chunk, last)
        if len(spect):
            steps.append((spect, first, last))
    return steps


def check_stream_chunks(label, eng, steps):
    """Every chunk step on the card, GRU kernel against the plain GRU from
    the same state; the kernel's state carries on."""
    from danspeech_tpu_torch.models import streaming

    params, config = eng._compute_params, eng.model.config
    state, got_all, ref_all, worst = None, [], [], 0.0
    for spect, first, last in steps:
        x, t = eng._stream_input(spect)
        if state is None:
            state = eng._new_stream_state(x.shape[-1])
        got, n, nxt = streaming.streaming_step_masked(
            params, config, x, t, state, first, last)
        ref, n_ref, _ = streaming.streaming_step_masked(
            params, config, x, t, state, first, last, rnn_impl="plain")
        state = nxt
        if got is None:
            continue
        if n != n_ref or got.shape[0] != 1 or got.shape[2] != config.num_classes:
            raise AssertionError(f"{label}: chunk probs {tuple(got.shape)}, out_len "
                                 f"{n} vs {n_ref}")
        worst = max(worst, float((got[:, :n] - ref[:, :n]).abs().max()))
        got_all.append(got[:, :n])
        ref_all.append(ref[:, :n])
    probs, ref = torch.cat(got_all, 1), torch.cat(ref_all, 1)
    res = compare_probs(f"{label}: {len(got_all)} chunks, kernel vs plain GRU",
                        probs, ref, torch.tensor([probs.shape[1]]), 1)
    res["worst_chunk_max_abs_prob_err"] = worst
    return res


def paced_speech_file(path):
    """A SpeechFile over ``path`` whose reads take as long as the audio they
    return, as a live microphone's do."""
    from danspeech_tpu_torch.audio.io import SpeechFile

    class PacedSpeechFile(SpeechFile):
        def __enter__(self):
            super().__enter__()
            inner, rate = self.stream, self.sampling_rate

            class Stream:
                def read(self, size=-1):
                    time.sleep(max(size, 0) / rate)
                    return inner.read(size)

            self.stream = Stream()
            return self

    return PacedSpeechFile(path)


def seeded_wav(path, rng):
    """1 s silence, 4 s speech-level noise, 2 s silence: 16-bit mono PCM."""
    speech = np.clip(rng.normal(size=4 * RATE) * 3000.0, -32768, 32767)
    pcm = np.concatenate([np.zeros(RATE), speech, np.zeros(2 * RATE)]).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(RATE)
        w.writeframes(pcm.tobytes())
    return len(pcm)


STREAM_PROFILE_GROUPS = {
    "B1 recurrence": ("gru_scan_persist_kernel", "gru_scan_step_kernel"),
    "B3 (secondary model)": ("gru_persist_kernel", "gru_step_kernel", "gru_proj"),
    "convolution": ("conv", "cudnn", "wgrad", "dgrad", "fprop"),
    "library GEMM": ("gemm", "cutlass", "nvjet", "cublas"),
}


def transpose_share(eng, chunk_busy_ms, card):
    """The device time that remaking the transposed copies of w_hh, which
    gru_scan's persistent route reads, would cost at every chunk (one per
    layer), against a steady chunk's device busy time; gru_cuda.transposed
    keeps one copy per weight tensor instead."""
    weights = [entry["fwd"].w_hh for entry in eng._compute_params["rnns"]]
    ms = sum(time_ms(lambda w=w: w.t().contiguous(), iters=20) for w in weights)
    share = ms / max(chunk_busy_ms, 1e-9)
    log(f"  w_hh transposed copies, {len(weights)} layers x {tuple(weights[0].shape)}: "
        f"{ms:.4f} ms a chunk if remade at every call = {100 * share:.1f}% of a steady "
        f"chunk's device time ({chunk_busy_ms:.3f} ms); kept per tensor instead [{card}]")
    return {"ms_per_chunk": ms, "chunk_busy_ms": chunk_busy_ms, "share": share}


def phase_stream(card):
    from danspeech_tpu_torch import Recognizer
    from danspeech_tpu_torch.models import DeepSpeechConfig, DeepSpeechModel
    from danspeech_tpu_torch.ops import gru_cuda

    config = DeepSpeechConfig(**GPU_STREAMING)
    t0 = time.perf_counter()
    model = DeepSpeechModel.init_random(config, seed=2)
    secondary = DeepSpeechModel.init_random(DeepSpeechConfig(**FLAGSHIP), seed=0)
    rec = Recognizer(model=model)  # device=None: CUDA
    eng = rec.danspeech_recognizer
    torch.cuda.synchronize()
    log(f"  {config.model_name} {config.rnn_layers}x{config.rnn_hidden_size} uni GRU, "
        f"{config.conv_layers} conv, RNN input {config.rnn_input_size}, lookahead "
        f"{config.context}, {model.get_param_size()} params; secondary "
        f"{secondary.model_name}: set up in {time.perf_counter() - t0:.1f} s")
    if eng.device.type != "cuda" or eng.compute_dtype != "bfloat16":
        raise AssertionError("the default engine must run bf16 on CUDA")
    layers, sec_layers = config.rnn_layers, secondary.config.rnn_layers
    out = {}

    # 5a: recognize_batch on the unidirectional model
    rng = np.random.default_rng(5)
    batches = [seeded_waveforms(rng, 128) for _ in range(2)]
    expected = layers * sum(len(eng._plan_groups(b)) for b in batches)
    gru_cuda.gru_scan.launches = 0
    zero_designs()
    serve = []
    for k, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        texts = rec.recognize_batch(batch)
        wall = time.perf_counter() - t0
        if len(texts) != len(batch) or not all(isinstance(t, str) for t in texts):
            raise AssertionError("recognize_batch returned the wrong shape")
        audio_s = sum(len(w) for w in batch) / RATE
        serve.append({"call": "recognize_batch", "input": f"uni batch{k}",
                      "audio_s": audio_s, "wall_s": wall, "audio_s_per_s": audio_s / wall})
        log(f"  recognize_batch(uni batch{k}): {audio_s:.2f} audio-s in {wall:.3f} s "
            f"= {audio_s / wall:.1f} audio-s/s [{card}]")
    batch_launches = gru_cuda.gru_scan.launches
    log(f"  gru_scan launches on the uni batch path: {batch_launches} (expected "
        f"{expected} = {layers} layers x dispatch groups)")
    if batch_launches != expected:
        raise AssertionError("the uni batch path did not run every GRU layer on gru_scan")
    require_persistent(gru_cuda.gru_scan, "uni batch")
    out["batch"] = {"launches": batch_launches, "serve": serve}
    out["batch"]["profile"] = profile_call(
        "one uni recognize_batch", lambda: rec.recognize_batch(batches[1]),
        groups=STREAM_PROFILE_GROUPS)
    idxs, maxlen = eng._plan_groups(batches[0])[0]
    staged, lengths = eng._stage_group(batches[0], idxs, maxlen)
    wave_d, lens = staged.to(eng.device), torch.from_numpy(lengths).to(eng.device)
    probs, out_lens = eng._forward(eng._compute_params, wave_d, lens)
    ref, _ = eng._forward(eng._compute_params, wave_d, lens, rnn_impl="plain")
    out["batch"]["vs_plain"] = compare_probs(
        f"uni group rows={len(idxs)} bucket={maxlen}: kernel vs plain GRU",
        probs, ref, out_lens, len(idxs))
    del probs, ref, wave_d
    torch.cuda.empty_cache()

    # 5b: streaming_transcribe over 8 s of seeded audio, each chunk timed
    rec.enable_real_time_streaming(model, secondary_model=secondary, string_parts=True)
    calls, sec_runs = record_calls(eng)
    audio = (np.random.default_rng(6).normal(size=8 * RATE) * 3000.0).astype(np.float32)
    plan = accumulate(audio, config.context)
    gru_cuda.gru_scan.launches = 0
    gru_cuda.gru_bidi_fused.launches = 0
    zero_designs()
    chunks, texts = [], []
    for chunk, first, last in plan:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text = eng.streaming_transcribe(chunk, is_last=last, is_first=first)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        kind = "first" if first else ("final" if last else "steady")
        chunks.append({"kind": kind, "samples": len(chunk), "ms": ms})
        texts.append(text)
    scan_direct = gru_cuda.gru_scan.launches
    bidi_direct = gru_cuda.gru_bidi_fused.launches
    steps = frame_steps(calls, config.audio_conf)
    log(f"  streaming_transcribe: {len(plan)} chunks over {len(audio) / RATE:.1f} s, "
        f"{len(steps)} with frames; gru_scan launches {scan_direct} (expected "
        f"{layers * len(steps)}), gru_bidi_fused launches {bidi_direct} (expected "
        f"{sec_layers * len(sec_runs)} = {sec_layers} x {len(sec_runs)} finals)")
    if scan_direct != layers * len(steps) or bidi_direct != sec_layers * len(sec_runs):
        raise AssertionError("streaming did not run every GRU layer on its kernel")
    if not sec_runs or not texts[-1]:
        raise AssertionError("the final chunk gave no secondary-model transcript")
    require_persistent(gru_cuda.gru_bidi_fused, "streaming rescore (flagship secondary)")
    require_persistent(gru_cuda.gru_scan, "streaming chunks")
    steady = sorted(c["ms"] for c in chunks if c["kind"] == "steady")
    for kind in ("first", "final"):
        log(f"    {kind} chunk: " + ", ".join(f"{c['ms']:.2f} ms ({c['samples']} samples)"
                                           for c in chunks if c["kind"] == kind))
    log(f"    steady chunks ({len(steady)} of {stream_requirements(config.context)[1]} "
        f"samples = {stream_requirements(config.context)[1] / RATE * 1e3:.0f} ms of "
        f"audio): min {steady[0]:.2f} ms, median {steady[len(steady) // 2]:.2f} ms, "
        f"max {steady[-1]:.2f} ms [{card}]")
    out["direct"] = {"chunks": chunks, "scan_launches": scan_direct,
                     "bidi_launches": bidi_direct, "finals": len(sec_runs),
                     "vs_plain": check_stream_chunks("streaming_transcribe", eng, steps)}
    out["direct"]["profile"] = profile_call(
        "3 steady streaming chunks",
        lambda: [eng.streaming_transcribe(c, is_last=False, is_first=False)
                 for c, _, _ in plan[1:4]], groups=STREAM_PROFILE_GROUPS)
    out["direct"]["w_hh_transpose"] = transpose_share(
        eng, out["direct"]["profile"]["device_busy_ms"] / 3, card)
    eng.reset_streaming_params()
    eng.audio_parser.reset()

    # 5c: real_time_streaming over a WAV read at a live microphone's pace
    rec.enable_real_time_streaming(model, secondary_model=secondary,
                                   string_parts=True, pipeline_depth=2)
    calls, sec_runs = record_calls(eng)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "seeded.wav")
        n_samples = seeded_wav(path, np.random.default_rng(7))
        gru_cuda.gru_scan.launches = 0
        gru_cuda.gru_bidi_fused.launches = 0
        zero_designs()
        yields = []
        t0 = time.perf_counter()
        # a stream that never ends ends the generator after 180 s
        watchdog = threading.Timer(180.0, lambda: setattr(rec, "stream", False))
        watchdog.daemon = True
        watchdog.start()
        for is_last, text in rec.real_time_streaming(paced_speech_file(path)):
            yields.append((is_last, text))
            if is_last:
                break
        wall = time.perf_counter() - t0
        watchdog.cancel()
        rec.disable_real_time_streaming(keep_secondary_model_loaded=True)
        rec.stream_thread_stopper(wait_for_stop=True)
    scan_rts = gru_cuda.gru_scan.launches
    bidi_rts = gru_cuda.gru_bidi_fused.launches
    steps = frame_steps(calls, config.audio_conf)
    partials = [t for last, t in yields if not last]
    log(f"  real_time_streaming over {n_samples / RATE:.1f} s of WAV in {wall:.2f} s: "
        f"{len(partials)} partials, final={bool(yields and yields[-1][0])}; "
        f"{len(calls)} chunks, {len(steps)} with frames; gru_scan launches "
        f"{scan_rts} (expected {layers * len(steps)}), gru_bidi_fused launches "
        f"{bidi_rts} (expected {sec_layers * len(sec_runs)})")
    if not partials or not (yields and yields[-1][0]):
        raise AssertionError("real_time_streaming gave no partial or no final")
    if scan_rts != layers * len(steps) or bidi_rts != sec_layers * len(sec_runs):
        raise AssertionError("real_time_streaming did not run every GRU layer on its kernel")
    require_persistent(gru_cuda.gru_scan, "real_time_streaming chunks")
    out["real_time"] = {"wall_s": wall, "partials": len(partials),
                        "scan_launches": scan_rts, "bidi_launches": bidi_rts,
                        "vs_plain": check_stream_chunks("real_time_streaming", eng, steps)}
    out["scan_launches"] = batch_launches + scan_direct + scan_rts
    out["bidi_launches"] = bidi_direct + bidi_rts
    return out


# ---------------------------------------------------------------------------
# Phase 6: the training path
# ---------------------------------------------------------------------------

TRAIN_BATCH = 32
TRAIN_LR = 1e-4
# kernel path against plain path, one batch: relative L2 error of the
# gradient of each parameter group. The two paths round the same operands
# to bf16 and differ by summation order, which flips single bf16 roundings
# of h and dgh and carries on through 9 layers and 401 steps both ways.
GRAD_REL_TOL = 5e-2

TRAIN_PROFILE_GROUPS = {
    "B4 walk": ("gru_bwd_persist_kernel", "gru_bwd_step_kernel"),
    "B3 recurrence": ("gru_persist_kernel", "gru_step_kernel"),
    "B1 recurrence": ("gru_scan_persist_kernel", "gru_scan_step_kernel"),
    "tensor-core GEMM (B3 projection, B4 recompute)": ("gru_proj",),
    "CTC": ("ctc",),
    "optimizer": ("adam", "multi_tensor", "foreach"),
    # before the GEMMs: cuDNN's kernels carry "gemm" in their names too
    "convolution": ("conv", "cudnn", "wgrad", "dgrad", "fprop"),
    "library GEMM": ("gemm", "cutlass", "nvjet", "cublas"),
}


def train_batch(rng, config, rows, lo_s=1.0, hi_s=8.0, sample_bucket=8000):
    """A seeded training batch as train/data.py lays it out: ``rows`` padded
    float32 waveforms of lo_s..hi_s seconds (the first as long as hi_s, so
    the padded shape is fixed) and label rows that fit their output frames
    with room for a blank between every pair."""
    from danspeech_tpu_torch.models.deepspeech import get_seq_lens

    waves = seeded_waveforms(rng, rows, lo_s, hi_s)
    waves[0] = seeded_waveforms(rng, 1, hi_s, hi_s)[0]
    lens = np.array([len(w) for w in waves], np.int32)
    maxlen = -(-int(lens.max()) // sample_bucket) * sample_bucket
    padded = np.zeros((rows, maxlen), np.float32)
    for r, w in enumerate(waves):
        padded[r, : len(w)] = w
    frames = np.asarray(get_seq_lens(config, 1 + lens // 160))
    label_lens = np.array([rng.integers(3, max(4, f // 3)) for f in frames], np.int32)
    labels = np.zeros((rows, int(-(-label_lens.max() // 8) * 8)), np.int32)
    for r, n in enumerate(label_lens):
        labels[r, :n] = rng.integers(1, config.num_classes, size=n)
    weights = np.ones((rows,), np.float32)
    return (padded, lens, labels, label_lens, weights), float(lens.sum()) / RATE


def timed_steps(label, step_fn, state, batch, audio_s, n, expect, card, rng=None):
    """``n`` train steps on ``batch``: each step's loss, wall time and the
    kernels' launch counts (held to ``expect``). Returns (state, steps)."""
    steps = []
    for k in range(n):
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step_fn(state, *batch, rng)
        loss = float(loss)  # waits for the device
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches()
        steps.append({"loss": loss, "wall_s": wall, "audio_s_per_step_s": audio_s / wall,
                      "launches": counts})
        log(f"  {label} step {k + 1}: loss {loss:.4f}, {wall:.3f} s, "
            f"{audio_s / wall:.1f} audio-s per step-second, launches "
            + ", ".join(f"{a} {c}" for a, c in counts.items() if c) + f" [{card}]")
        if not np.isfinite(loss):
            raise AssertionError(f"{label}: step {k + 1} gave a non-finite loss")
        if counts != expect:
            raise AssertionError(f"{label}: launches {counts}, expected {expect}")
    return state, steps


def grad_groups(params):
    """Gradients of a parameter tree by group: {group: flat f32 tensor}."""
    from danspeech_tpu_torch.models.checkpoint import flatten_tree
    from danspeech_tpu_torch.models.deepspeech import map_params

    flat = flatten_tree(map_params(lambda p: p.grad, params))
    groups: dict[str, list] = {}
    for name, g in flat.items():
        leaf = name.rsplit(".", 1)[1]
        if name.startswith("conv."):
            key = "conv BN statistics" if leaf in ("bn_mean", "bn_var") else "conv"
        elif leaf in ("w_ih", "w_hh"):
            key = f"RNN {leaf}"
        elif leaf in ("b_ih", "b_hh"):
            key = "RNN biases"
        elif name.startswith("fc."):
            key = "fc"
        else:
            key = "BN"
        groups.setdefault(key, []).append(torch.from_numpy(g).reshape(-1))
    return {k: torch.cat(v) for k, v in groups.items()}


def sum_launches(*step_lists):
    total: dict[str, int] = {}
    for steps in step_lists:
        for s in steps:
            for name, c in s["launches"].items():
                total[name] = total.get(name, 0) + c
    return total


def seeded_manifest(tmp, rng, labels, n):
    """``n`` seeded WAVs of 1-3 s with seeded transcripts, and their
    manifest."""
    letters = [c for c in labels if c not in "_ "]
    lines = []
    for i, pcm in enumerate(seeded_waveforms(rng, n, 1.0, 3.0)):
        path = os.path.join(tmp, f"utt{i}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(RATE)
            w.writeframes(pcm.astype("<i2").tobytes())
        words = ["".join(rng.choice(letters, size=rng.integers(2, 6)))
                 for _ in range(rng.integers(1, 4))]
        lines.append(f"{path},{' '.join(words)}")
    manifest = os.path.join(tmp, "train.csv")
    with open(manifest, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return manifest


def phase_train(card):
    from danspeech_tpu_torch import Recognizer, train as tr
    from danspeech_tpu_torch.audio import load_audio_pcm16
    from danspeech_tpu_torch.models import DeepSpeechConfig, DeepSpeechModel
    from danspeech_tpu_torch.ops import gru_cuda
    from danspeech_tpu_torch.train.checkpoint import latest_step

    out = {}
    zero = dict.fromkeys(kernel_wrappers(), 0)

    # 6a: the flagship, full width and depth, mixed precision, remat
    config = DeepSpeechConfig(**FLAGSHIP)
    layers = config.rnn_layers
    optimizer = tr.make_optimizer(TRAIN_LR)
    t0 = time.perf_counter()
    state = tr.init_train_state(config, optimizer, seed=0)  # device=None: CUDA
    torch.cuda.synchronize()
    log(f"  flagship train state ({layers}x{config.rnn_hidden_size} bidi GRU, f32 "
        f"masters + Adam) set up in {time.perf_counter() - t0:.1f} s")
    batch, audio_s = train_batch(np.random.default_rng(8), config, TRAIN_BATCH)
    log(f"  batch: {TRAIN_BATCH} rows, {audio_s:.1f} audio-s, padded to "
        f"{batch[0].shape[1]} samples, labels {batch[2].shape[1]} wide")
    # with remat the forward kernel runs in the forward and again in the backward
    expect = dict(zero, gru_bidi_fused=2 * layers, gru_bwd_scan=2 * layers)
    step_fn = tr.make_wave_train_step(config, optimizer, augment=None,
                                      mixed_precision="auto", remat=True)
    torch.cuda.reset_peak_memory_stats()
    zero_designs()
    state, steps = timed_steps("flagship", step_fn, state, batch, audio_s, 2,
                               expect, card)
    holder = {}

    def third():
        holder["state"], holder["steps"] = timed_steps(
            "flagship (profiled)", step_fn, state, batch, audio_s, 1, expect, card)

    out["profile"] = profile_call("one flagship train step", third,
                                  groups=TRAIN_PROFILE_GROUPS)
    state, steps = holder["state"], steps + holder["steps"]
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory over 3 steps: {peak / 2**30:.2f} GiB")
    if not steps[2]["loss"] < steps[0]["loss"]:
        raise AssertionError(
            f"flagship: the loss did not fall over two updates on one batch: "
            f"{[s['loss'] for s in steps]}")
    aug_fn = tr.make_wave_train_step(config, optimizer, augment=True,
                                     mixed_precision="auto", remat=True)
    state, aug_steps = timed_steps("flagship + SpecAugment", aug_fn, state, batch,
                                   audio_s, 1, expect, card,
                                   rng=torch.Generator().manual_seed(0))
    if state.step != 4:
        raise AssertionError(f"4 updates were taken, the state counts {state.step}")
    require_persistent(gru_cuda.gru_bidi_fused, "flagship training, forward")
    require_persistent(gru_cuda.gru_bwd_scan, "flagship training, backward walks")
    out["flagship"] = {"steps": steps, "augment_steps": aug_steps,
                       "peak_memory_bytes": peak, "audio_s": audio_s,
                       "batch_rows": TRAIN_BATCH, "lr": TRAIN_LR}
    del state, holder
    torch.cuda.empty_cache()

    # 6b: gradients of one batch of 8 rows, kernel path against plain path
    small, _ = train_batch(np.random.default_rng(9), config, 8)
    grads = {}
    for impl in ("auto", "plain"):
        st = tr.init_train_state(config, optimizer, seed=0)
        fn = tr.make_wave_train_step(config, optimizer, augment=None,
                                     mixed_precision="auto", remat=True, rnn_impl=impl)
        before = gru_cuda.gru_bwd_scan.launches
        t0 = time.perf_counter()
        st, loss = fn(st, *small)
        grads[impl] = (grad_groups(st.params), float(loss))
        log(f"  8-row step, rnn_impl={impl!r}: loss {grads[impl][1]:.5f}, "
            f"{time.perf_counter() - t0:.2f} s, gru_bwd_scan launches "
            f"{gru_cuda.gru_bwd_scan.launches - before}")
        del st, fn
        torch.cuda.empty_cache()
    rel = {}
    for group, ref in grads["plain"][0].items():
        got = grads["auto"][0][group]
        if not torch.isfinite(got).all():
            raise AssertionError(f"{group}: non-finite gradient from the kernel path")
        rel[group] = float((got - ref).norm() / ref.norm().clamp(min=1e-30))
    log("  gradient, kernel path vs plain path, relative L2 error by group: "
        + ", ".join(f"{g} {e:.3e}" for g, e in rel.items())
        + f" (limit {GRAD_REL_TOL})")
    if not all(e <= GRAD_REL_TOL for e in rel.values()):
        raise AssertionError("kernel-path gradients outside the stated limit")
    out["grad_vs_plain"] = {"rel_l2": rel, "limit": GRAD_REL_TOL,
                            "loss_kernel": grads["auto"][1],
                            "loss_plain": grads["plain"][1]}
    del grads

    # 6c: the unidirectional route (B1 forward, B4 backward), depth cut to 2
    uni = DeepSpeechConfig(**dict(GPU_STREAMING, rnn_layers=2))
    ustate = tr.init_train_state(uni, optimizer, seed=2)
    ubatch, uaudio = train_batch(np.random.default_rng(10), uni, TRAIN_BATCH)
    ufn = tr.make_wave_train_step(uni, optimizer, augment=None,
                                  mixed_precision="auto", remat=True)
    uexpect = dict(zero, gru_scan=2 * uni.rnn_layers, gru_bwd_scan=uni.rnn_layers)
    zero_designs()
    ustate, usteps = timed_steps(
        f"uni {uni.rnn_layers}x{uni.rnn_hidden_size}", ufn, ustate, ubatch, uaudio, 2,
        uexpect, card)
    require_persistent(gru_cuda.gru_scan, "uni training, forward (H=2000)")
    require_persistent(gru_cuda.gru_bwd_scan, "uni training, backward walks (H=2000)")
    out["uni"] = {"steps": usteps, "audio_s": uaudio, "rnn_layers": uni.rnn_layers}
    del ustate, ufn
    torch.cuda.empty_cache()

    # 6d: train() itself on a manifest, resume, export, recognise. Depth cut
    # to 3 layers: the checkpoints of the full depth are 2 GB each
    loop_cfg = DeepSpeechConfig(**dict(FLAGSHIP, rnn_layers=3))
    for w in (gru_cuda.gru_bidi_fused, gru_cuda.gru_bwd_scan):
        w.launches = 0
    zero_designs()
    with tempfile.TemporaryDirectory() as tmp:
        manifest = seeded_manifest(tmp, np.random.default_rng(11), loop_cfg.labels, 8)
        ckpt = os.path.join(tmp, "ckpt")
        lines = []
        t0 = time.perf_counter()
        st = tr.train(loop_cfg, manifest, epochs=1, batch_size=4, learning_rate=TRAIN_LR,
                      checkpoint_dir=ckpt, val_manifest=manifest, log=lines.append)
        st = tr.continue_training(loop_cfg, manifest, ckpt, epochs=2, batch_size=4,
                                  learning_rate=TRAIN_LR, log=lines.append)
        for line in lines:
            log(f"    {line}")
        if st.step != 4 or latest_step(ckpt) != 4:
            raise AssertionError(f"train + continue_training: step {st.step}, newest "
                                 f"checkpoint {latest_step(ckpt)}, expected 4")
        if not any("resumed step 2 (epoch 1)" in line for line in lines):
            raise AssertionError("continue_training did not resume at epoch 1")
        path = tr.export_model(st, loop_cfg, os.path.join(tmp, "trained.dsz"))
        rec = Recognizer(model=DeepSpeechModel.load_model(path))
        clip = sorted(glob.glob(os.path.join("tests", "data", "clip_*.wav")))[0]
        text = rec.recognize(load_audio_pcm16(clip))
        if not isinstance(text, str):
            raise AssertionError(f"recognize returned {type(text)}")
        log(f"  train (1 epoch) + continue_training (1 more) + export_model + "
            f"Recognizer.recognize on {loop_cfg.rnn_layers}x{loop_cfg.rnn_hidden_size}: "
            f"{time.perf_counter() - t0:.1f} s, transcript {text!r}")
    # 4 train steps x (2 forwards with remat + the validation forward of epoch 0
    # + the recognize call), 4 x 2 directions backward
    loop_counts = {"gru_bidi_fused": gru_cuda.gru_bidi_fused.launches,
                   "gru_bwd_scan": gru_cuda.gru_bwd_scan.launches}
    want_bwd = 4 * 2 * loop_cfg.rnn_layers
    log(f"  loop launches: {loop_counts} (expected gru_bwd_scan {want_bwd})")
    if loop_counts["gru_bwd_scan"] != want_bwd or loop_counts["gru_bidi_fused"] <= want_bwd:
        raise AssertionError("train() did not run every GRU layer on the kernels")
    require_persistent(gru_cuda.gru_bidi_fused, "train() loop, forward (small ragged batches)")
    require_persistent(gru_cuda.gru_bwd_scan, "train() loop, backward walks")
    out["loop"] = {"launches": loop_counts, "log": lines}

    out["launches"] = sum_launches(steps, aug_steps, usteps)
    for name, c in loop_counts.items():
        out["launches"][name] += c
    return out


# ---------------------------------------------------------------------------
# Phase 7: LSTM and tanh-RNN models, served and trained
# ---------------------------------------------------------------------------

RNN_TYPE_PROFILE_GROUPS = {
    "B7 walk": ("lstm_bwd_persist_kernel", "lstm_bwd_step_kernel"),
    "B5/B6 recurrence": ("lstm_persist_kernel", "lstm_step_kernel"),
    "B9 walk": ("rnn_tanh_bwd_persist_kernel", "rnn_tanh_bwd_step_kernel"),
    "B8 recurrence": ("rnn_tanh_persist_kernel", "rnn_tanh_step_kernel"),
    "tensor-core GEMM (B7 recompute)": ("gru_proj_wgmma_kernel", "gru_proj_kernel"),
    "CTC": ("ctc",),
    "optimizer": ("adam", "multi_tensor", "foreach"),
    "convolution": ("conv", "cudnn", "wgrad", "dgrad", "fprop"),
    "library GEMM": ("gemm", "cutlass", "nvjet", "cublas"),
}


def phase_rnn_type(card, cfg, train_steps, profile, loop):
    """Serve and train one LSTM or tanh-RNN configuration. Returns its
    results with ``launches``, the kernels' counts summed over its main
    paths (each path driven with the counts at zero and read right after),
    and ``pair_launches``, the cooperative launches of two chains of the
    wrappers that count chains, summed the same way."""
    from danspeech_tpu_torch import Recognizer, train as tr
    from danspeech_tpu_torch.audio import load_audio_pcm16
    from danspeech_tpu_torch.models import DeepSpeechConfig, DeepSpeechModel
    from danspeech_tpu_torch.models.deepspeech import get_seq_lens
    from danspeech_tpu_torch.ops import lstm_cuda, rnn_tanh_cuda

    config = DeepSpeechConfig(**cfg)
    name, layers = config.model_name, config.rnn_layers
    lstm = config.rnn_type == "lstm"
    zero = dict.fromkeys(kernel_wrappers(), 0)
    total = dict(zero)
    out = {}

    def add(counts):
        for k, c in counts.items():
            total[k] += c

    # 7a: serve through Recognizer
    t0 = time.perf_counter()
    model = DeepSpeechModel.init_random(config, seed=12)
    rec = Recognizer(model=model)  # device=None: CUDA
    eng = rec.danspeech_recognizer
    torch.cuda.synchronize()
    log(f"  {name}: {layers}x{config.rnn_hidden_size} bidi {config.rnn_type}, "
        f"{config.conv_layers} conv, RNN input {config.rnn_input_size}, "
        f"{model.get_param_size()} params: set up in {time.perf_counter() - t0:.1f} s")
    if eng.device.type != "cuda" or eng.compute_dtype != "bfloat16":
        raise AssertionError("the default engine must run bf16 on CUDA")
    clip = sorted(glob.glob(os.path.join("tests", "data", "clip_*.wav")))[0]
    clip_audio = load_audio_pcm16(clip)
    batch = seeded_waveforms(np.random.default_rng(13), 128)
    groups = 1 + len(eng._plan_groups(batch))
    fwd_kernel = "lstm_scan" if lstm else "rnn_tanh_scan"
    # a layer's two chains are one launch (lstm_scan_pair, rnn_tanh_scan_pair);
    # lstm_scan counts launches, rnn_tanh_scan chains
    chains = 1 if lstm else 2
    expect = dict(zero, **{fwd_kernel: chains * layers * groups})
    rec.recognize_batch(batch[:4])  # warm-up: cuDNN picks its conv algorithms
    zero_launches()
    zero_designs()
    t0 = time.perf_counter()
    text = rec.recognize(clip_audio)
    clip_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    texts = rec.recognize_batch(batch)
    wall = time.perf_counter() - t0
    counts = read_launches()
    if not isinstance(text, str) or len(texts) != len(batch) or not all(
            isinstance(t, str) for t in texts):
        raise AssertionError(f"{name}: recognize / recognize_batch returned the wrong shape")
    audio_s = sum(len(w) for w in batch) / RATE
    log(f"  {name} recognize({os.path.basename(clip)}): {clip_s * 1e3:.1f} ms; "
        f"recognize_batch: {audio_s:.2f} audio-s in {wall:.3f} s = "
        f"{audio_s / wall:.1f} audio-s/s; launches "
        + ", ".join(f"{a} {c}" for a, c in counts.items() if c)
        + f" (expected {fwd_kernel} {expect[fwd_kernel]} = {chains} count(s) x {layers} "
        f"layers x {groups} dispatch groups) [{card}]")
    if counts != expect:
        raise AssertionError(f"{name} serve: launches {counts}, expected {expect}")
    pairs = {}
    if lstm:
        require_persistent(lstm_cuda.lstm_scan, f"{name} serving")
    else:
        require_persistent(rnn_tanh_cuda.rnn_tanh_scan, f"{name} serving")
        pairs["rnn_tanh_scan"] = rnn_tanh_cuda.rnn_tanh_scan.pair_launches
        log(f"  {name} serving: {pairs['rnn_tanh_scan']} paired rnn_tanh_scan launches "
            f"(expected {layers * groups}: both chains of a layer in one)")
        if pairs["rnn_tanh_scan"] != layers * groups:
            raise AssertionError(f"{name} serve: {pairs['rnn_tanh_scan']} paired launches, "
                                 f"expected {layers * groups}")
    add(counts)
    out["serve"] = {"recognize_s": clip_s, "audio_s": audio_s, "wall_s": wall,
                    "audio_s_per_s": audio_s / wall,
                    "launches": counts, "dispatch_groups": groups,
                    "pair_launches": dict(pairs)}
    if profile:
        out["serve"]["profile"] = profile_call(
            f"one {name} recognize_batch", lambda: rec.recognize_batch(batch),
            groups=RNN_TYPE_PROFILE_GROUPS)
    # the largest dispatch group, kernels against the plain recurrence on the card
    idxs, maxlen = max(eng._plan_groups(batch), key=lambda g: len(g[0]) * g[1])
    staged, lengths = eng._stage_group(batch, idxs, maxlen)
    wave_d, lens = staged.to("cuda"), torch.from_numpy(lengths).to("cuda")
    probs, out_lens = eng._forward(eng._compute_params, wave_d, lens)
    ref, _ = eng._forward(eng._compute_params, wave_d, lens, rnn_impl="plain")
    torch.cuda.synchronize()
    frames = int(get_seq_lens(config, 1 + maxlen // eng.audio_parser.hop_length))
    if tuple(probs.shape) != (len(lengths), frames, config.num_classes):
        raise AssertionError(f"{name}: probs shape {tuple(probs.shape)}")
    out["serve"]["vs_plain"] = compare_probs(
        f"{name} group rows={len(idxs)} bucket={maxlen}: kernel vs plain recurrence",
        probs, ref, out_lens, len(idxs))
    del probs, ref, wave_d, rec, eng, model
    torch.cuda.empty_cache()

    # 7b: train steps at B = 32, mixed precision, remat
    optimizer = tr.make_optimizer(TRAIN_LR)
    state = tr.init_train_state(config, optimizer, seed=12)  # device=None: CUDA
    tbatch, taudio = train_batch(np.random.default_rng(14), config, TRAIN_BATCH)
    if lstm:
        # with remat the first forward keeps nothing (B5), the recomputed one
        # keeps the cell streams (B6), each a pair of chains in one launch;
        # one walk per direction (B7)
        texpect = dict(zero, lstm_scan=layers, lstm_scan_with_cell=layers,
                       lstm_bwd_scan=2 * layers)
    else:
        # with remat both forwards run every layer's pair of chains (B8), and
        # one launch walks both chains of a layer (B9); the counts are chains
        texpect = dict(zero, rnn_tanh_scan=4 * layers, rnn_tanh_bwd_scan=2 * layers)
    step_fn = tr.make_wave_train_step(config, optimizer, augment=None,
                                      mixed_precision="auto", remat=True)
    torch.cuda.reset_peak_memory_stats()
    zero_designs()
    state, steps = timed_steps(name, step_fn, state, tbatch, taudio, train_steps - 1,
                               texpect, card)
    holder = {}

    def last_step():
        holder["state"], holder["steps"] = timed_steps(
            f"{name} (last)", step_fn, state, tbatch, taudio, 1, texpect, card)

    if profile:
        out["train_profile"] = profile_call(f"one {name} train step", last_step,
                                            groups=RNN_TYPE_PROFILE_GROUPS)
    else:
        last_step()
    steps += holder["steps"]
    if lstm:
        require_persistent(lstm_cuda.lstm_scan, f"{name} training, first forward")
        require_persistent(lstm_cuda.lstm_scan_with_cell, f"{name} training, recomputed forward")
        require_persistent(lstm_cuda.lstm_bwd_scan, f"{name} training, backward walks")
        paired = {"lstm_bwd_scan": (lstm_cuda.lstm_bwd_scan, layers)}
    else:
        require_persistent(rnn_tanh_cuda.rnn_tanh_scan, f"{name} training, both forwards")
        require_persistent(rnn_tanh_cuda.rnn_tanh_bwd_scan, f"{name} training, backward walks")
        paired = {"rnn_tanh_scan": (rnn_tanh_cuda.rnn_tanh_scan, 2 * layers),
                  "rnn_tanh_bwd_scan": (rnn_tanh_cuda.rnn_tanh_bwd_scan, layers)}
    for kernel, (wrapper, per_step) in paired.items():
        n = wrapper.pair_launches
        log(f"  {name} training: {n} paired {kernel} launches over {train_steps} steps "
            f"(expected {per_step} a step: both chains of a layer in one)")
        if n != per_step * train_steps:
            raise AssertionError(f"{name}: {n} paired {kernel} launches, expected "
                                 f"{per_step * train_steps}")
        pairs[kernel] = pairs.get(kernel, 0) + n
    peak = torch.cuda.max_memory_allocated()
    log(f"  {name}: peak device memory over {train_steps} steps: {peak / 2**30:.2f} GiB")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError(f"{name}: the loss did not fall on one batch: "
                             f"{[s['loss'] for s in steps]}")
    add(sum_launches(steps))
    out["train"] = {"steps": steps, "peak_memory_bytes": peak, "audio_s": taudio,
                    "batch_rows": TRAIN_BATCH, "lr": TRAIN_LR}
    del state, holder
    torch.cuda.empty_cache()

    # 7c: gradients of one batch of 8 rows, kernel path against plain path
    small, _ = train_batch(np.random.default_rng(15), config, 8)
    grads = {}
    for impl in ("auto", "plain"):
        st = tr.init_train_state(config, optimizer, seed=12)
        fn = tr.make_wave_train_step(config, optimizer, augment=None,
                                     mixed_precision="auto", remat=True, rnn_impl=impl)
        t0 = time.perf_counter()
        st, loss = fn(st, *small)
        grads[impl] = (grad_groups(st.params), float(loss))
        log(f"  {name} 8-row step, rnn_impl={impl!r}: loss {grads[impl][1]:.5f}, "
            f"{time.perf_counter() - t0:.2f} s")
        del st, fn
        torch.cuda.empty_cache()
    rel = {}
    for group, ref in grads["plain"][0].items():
        got = grads["auto"][0][group]
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name} {group}: non-finite gradient from the kernel path")
        rel[group] = float((got - ref).norm() / ref.norm().clamp(min=1e-30))
    log(f"  {name} gradient, kernel path vs plain path, relative L2 error by group: "
        + ", ".join(f"{g} {e:.3e}" for g, e in rel.items())
        + f" (limit {GRAD_REL_TOL})")
    if not all(e <= GRAD_REL_TOL for e in rel.values()):
        raise AssertionError(f"{name}: kernel-path gradients outside the stated limit")
    out["grad_vs_plain"] = {"rel_l2": rel, "limit": GRAD_REL_TOL,
                            "loss_kernel": grads["auto"][1],
                            "loss_plain": grads["plain"][1]}
    del grads

    # 7d: train() on a manifest, export, recognise, on a 2-layer cut
    if loop:
        loop_cfg = DeepSpeechConfig(**dict(cfg, rnn_layers=2))
        with tempfile.TemporaryDirectory() as tmp:
            manifest = seeded_manifest(tmp, np.random.default_rng(16), loop_cfg.labels, 8)
            lines = []
            t0 = time.perf_counter()
            zero_launches()
            zero_designs()
            st = tr.train(loop_cfg, manifest, epochs=1, batch_size=4,
                          learning_rate=TRAIN_LR, log=lines.append)
            path = tr.export_model(st, loop_cfg, os.path.join(tmp, "trained.dsz"))
            rec = Recognizer(model=DeepSpeechModel.load_model(path))
            text = rec.recognize(clip_audio)
            counts = read_launches()
            for line in lines:
                log(f"    {line}")
            if st.step != 2 or not isinstance(text, str):
                raise AssertionError(f"{name} loop: step {st.step}, transcript {text!r}")
            log(f"  {name} train (1 epoch, 2 steps) + export_model + Recognizer.recognize "
                f"on a {loop_cfg.rnn_layers}-layer cut: {time.perf_counter() - t0:.1f} s, "
                f"transcript {text!r}, launches "
                + ", ".join(f"{a} {c}" for a, c in counts.items() if c))
        # per step and layer: one launch each of B5 (first pass) and B6
        # (recomputed), both chains of the layer in it, and a B7 per chain;
        # the recognize call adds one B5 per layer
        per = 2 * loop_cfg.rnn_layers
        want = dict(zero, lstm_scan=per + loop_cfg.rnn_layers,
                    lstm_scan_with_cell=per, lstm_bwd_scan=2 * per)
        if counts != want:
            raise AssertionError(f"{name} loop: launches {counts}, expected {want}")
        if lstm:
            pairs["lstm_bwd_scan"] += lstm_cuda.lstm_bwd_scan.pair_launches
        add(counts)
        out["loop"] = {"launches": counts, "log": lines}

    out["launches"] = total
    out["pair_launches"] = pairs
    return out


# ---------------------------------------------------------------------------
# Phase 8: serving with a language model
# ---------------------------------------------------------------------------

# a stand-in for the DSL 3-gram until the zoo's LM files are in the
# repository: seeded words of 2-10 letters of the model's labels, seeded
# bigrams and trigrams over them
LM_WORDS, LM_BIGRAMS, LM_TRIGRAMS = 20000, 100000, 100000
# the published serving settings, the engine's defaults: alpha, beta, beam
LM_ALPHA, LM_BETA, LM_BEAM = 1.3, 0.2, 64
# where two decoders' best transcripts differ, the row passes as a float32
# near tie only if the device beam on the card, searching the same
# probabilities with float64 scores, picks the host beam's transcript (or,
# between two float32 searches, one of the two), and the two best scores
# lie within this share of their size: the host beam sums in float64, the
# device beam in float32 over up to 700 frames of scores in the thousands
BEAM_GAP_REL = 1e-3
CROSSOVER_BATCHES = (1, 2, 4, 8, 16, 32, 64, 128)
LM_PROFILE_GROUPS = {
    "B3 recurrence": ("gru_persist_kernel", "gru_step_kernel"),
    "tensor-core GEMM (B3 projection)": ("gru_proj",),
    "sort (beam top-k)": ("sort", "radix"),
    "gather / scatter (LM probes, pointers)": ("gather", "scatter", "index"),
    "convolution": ("conv", "cudnn", "wgrad", "dgrad", "fprop"),
    "library GEMM": ("gemm", "cutlass", "nvjet", "cublas"),
    "elementwise": ("elementwise", "vectorized", "reduce"),
}


def synthetic_lm_arpa(path, labels, seed):
    """Write a seeded 3-gram LM as ARPA text: LM_WORDS distinct words of
    2-10 letters (no blank, no space), Zipf-like unigram probabilities by
    rank, LM_BIGRAMS and LM_TRIGRAMS distinct random n-grams; log10 values
    with four decimals. Returns the number of lines written."""
    rng = np.random.default_rng(seed)
    letters = [c for c in labels if c not in "_ "]
    words: dict = {}
    while len(words) < LM_WORDS:
        for n in rng.integers(2, 11, size=LM_WORDS):
            words.setdefault("".join(letters[i] for i in rng.integers(0, len(letters), n)))
            if len(words) == LM_WORDS:
                break
    words = list(words)
    ranks = np.arange(1, LM_WORDS + 1)
    uni = -np.log10(ranks) - np.log10((1.0 / ranks).sum())

    def distinct(order, count):
        out: dict = {}
        while len(out) < count:
            for row in rng.integers(0, LM_WORDS, size=(count, order)):
                out.setdefault(tuple(int(i) for i in row))
                if len(out) == count:
                    break
        return list(out)

    bigrams, trigrams = distinct(2, LM_BIGRAMS), distinct(3, LM_TRIGRAMS)
    lines = ["\\data\\", f"ngram 1={LM_WORDS + 1}", f"ngram 2={len(bigrams)}",
             f"ngram 3={len(trigrams)}", "", "\\1-grams:", "-6.0000\t<unk>\t0.0000"]
    lines += [f"{p:.4f}\t{w}\t{b:.4f}"
              for w, p, b in zip(words, uni, rng.uniform(-1.0, 0.0, LM_WORDS))]
    lines += ["", "\\2-grams:"]
    lines += [f"{p:.4f}\t{words[a]} {words[b]}\t{bo:.4f}" for (a, b), p, bo in zip(
        bigrams, rng.uniform(-2.0, -0.1, len(bigrams)), rng.uniform(-1.0, 0.0, len(bigrams)))]
    lines += ["", "\\3-grams:"]
    lines += [f"{p:.4f}\t{words[a]} {words[b]} {words[c]}" for (a, b, c), p in zip(
        trigrams, rng.uniform(-1.5, -0.05, len(trigrams)))]
    lines += ["", "\\end\\", ""]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))
    return len(lines)


def peaky_probs(rng, lm, labels, rows, t_max):
    """Speech-like (rows, t_max, C) CTC posteriors: each row spells a
    seeded word sequence of the LM (a walk along its bigrams from a word
    drawn by Zipf weights), each label for 1-2 frames followed by 0-2 blank
    frames (one at least between two equal labels). A letter frame gives
    its letter 0.35-0.95 of the mass, a blank frame 0.9-0.995 and a space
    frame 0.999-0.99999, as a CTC model is surest at word boundaries; a
    Dirichlet draw spreads the rest, so that the beam has choices and the
    LM scores decide some of them."""
    index = {ch: i for i, ch in enumerate(labels)}
    blank, c = index["_"], len(labels)
    succ: dict = {}
    for a, b in lm.tables[1]:
        succ.setdefault(a, []).append(b)
    # a word opens a walk with Zipf weights by its rank (its id), as frequent
    # words open sentences
    starts = sorted(succ)

    def opening():
        return starts[min(int(rng.zipf(1.5)), len(starts)) - 1]

    probs = np.empty((rows, t_max, c), np.float32)
    texts = []
    for r in range(rows):
        w = opening()
        path, spoken = [], []
        while len(path) < t_max:
            spoken.append(lm.words[w])
            for ch in lm.words[w] + " ":
                k = index[ch]
                if path and path[-1] == k:
                    path.append(blank)
                path += [k] * int(rng.integers(1, 3)) + [blank] * int(rng.integers(0, 3))
            nxt = succ.get(w)
            w = nxt[int(rng.integers(len(nxt)))] if nxt else opening()
        path = np.asarray(path[:t_max])
        conf = np.select([path == index[" "], path == blank],
                         [rng.uniform(0.999, 0.99999, t_max), rng.uniform(0.9, 0.995, t_max)],
                         rng.uniform(0.35, 0.95, t_max))
        p = rng.dirichlet(np.full(c, 2.0), t_max) * (1.0 - conf)[:, None]
        p[np.arange(t_max), path] += conf
        probs[r] = p
        texts.append(" ".join(spoken))
    return probs, texts


def device_tops(probs, lengths, dlm, labels, keep_pointers=None):
    """The device beam's best transcript and its score per row (the
    published settings), on ``probs``' device. ``keep_pointers`` (a list)
    receives the per-frame pointer tensors of the search."""
    from danspeech_tpu_torch.decode import device_beam

    real = device_beam.backtrack_beams

    def kept(pb, pnb, parents, chars, t_max, extra_scores=None, top=None):
        if keep_pointers is not None:
            keep_pointers.extend([parents, chars])
        return real(pb, pnb, parents, chars, t_max, extra_scores=extra_scores, top=top)

    device_beam.backtrack_beams = kept
    try:
        lab, _, lens, scores = device_beam.ctc_beam_search_device(
            probs, lengths, beam_width=LM_BEAM, blank=labels.index("_"), lm=dlm,
            alpha=LM_ALPHA, beta=LM_BETA, space=labels.index(" "), top=1)
    finally:
        device_beam.backtrack_beams = real
    lab, lens, scores = lab.cpu().numpy(), lens.cpu().numpy(), scores.cpu().numpy()
    return ["".join(labels[i] for i in lab[b, 0, : lens[b, 0]]) for b in range(len(lab))], \
        scores[:, 0].astype(np.float64)


def host_tops(host, probs, lengths, labels):
    """The C++ host beam's best transcript and its score per row."""
    rows = host._native.decode_batch(np.ascontiguousarray(probs), np.asarray(lengths, np.int32))
    return ["".join(labels[i] for i in r[0][0]) for r in rows], \
        np.array([r[0][1] for r in rows])


def compare_tops(label, a, b, probs, lengths, dlm, labels, host_b):
    """Top-1 transcripts of two decoders, row for row: equal, or a float32
    near tie (BEAM_GAP_REL). ``a`` and ``b`` are (transcripts, scores) of
    the rows of ``probs`` / ``lengths``; ``host_b`` says that ``b`` is the
    host beam's. Returns the number of flips and the largest gap."""
    flips, worst = 0, 0.0
    for r, (ta, tb, sa, sb) in enumerate(zip(a[0], b[0], a[1], b[1])):
        if ta == tb:
            continue
        gap = abs(float(sa) - float(sb))
        rel = gap / max(abs(float(sa)), abs(float(sb)), 1.0)
        p64 = torch.as_tensor(probs[r : r + 1]).to(dlm.device, torch.float64)
        ref = device_tops(p64, [int(lengths[r])], dlm, labels)[0][0]
        agrees = ref == tb if host_b else ref in (ta, tb)
        flips += 1
        worst = max(worst, gap)
        log(f"    {label}: row {r} differs, scores {float(sa):.6f} vs {float(sb):.6f} "
            f"(gap {gap:.3e}, {rel:.2e} of their size); the float64 search picks "
            f"{'the host beam' if ref == tb and host_b else 'one of the two' if agrees else 'neither'}")
        if not agrees or rel > BEAM_GAP_REL:
            raise AssertionError(f"{label}: row {r} differs beyond a float32 near tie")
    log(f"  {label}: {len(a[0]) - flips} of {len(a[0])} rows equal, {flips} float32 "
        f"near-tie flips (largest gap {worst:.3e})")
    return {"rows": len(a[0]), "flips": flips, "max_gap": worst}


def crossover_of(host_ms, dev_ms):
    """The smallest batch from which the device beam is faster at every
    measured batch, or None where it never is."""
    batches = sorted(host_ms)
    for k, b in enumerate(batches):
        if all(dev_ms[x] < host_ms[x] for x in batches[k:]):
            return b
    return None


def group_probs(eng, waves, i):
    """The probabilities of row ``i`` of ``waves`` as its dispatch group
    computes them: ((1, T', C) on the card, length)."""
    for idxs, maxlen in eng._plan_groups(waves):
        if i in idxs:
            staged, lengths = eng._stage_group(waves, idxs, maxlen)
            probs, out_lens = eng._forward(eng._compute_params, staged.to(eng.device),
                                           torch.from_numpy(lengths).to(eng.device))
            j = idxs.index(i)
            return probs[j : j + 1], int(out_lens[j])
    raise KeyError(i)


def phase_lm(card):
    from danspeech_tpu_torch import Recognizer
    from danspeech_tpu_torch.audio import load_audio_pcm16
    from danspeech_tpu_torch.decode import beam_auto
    from danspeech_tpu_torch.decode.beam import BeamCTCDecoder
    from danspeech_tpu_torch.decode.device_beam import DeviceBeamDecoder
    from danspeech_tpu_torch.decode.device_lm import pack_device_lm
    from danspeech_tpu_torch.decode.lm import load_arpa
    from danspeech_tpu_torch.models import DeepSpeechConfig, DeepSpeechModel
    from danspeech_tpu_torch.ops import gru_cuda

    config = DeepSpeechConfig(**FLAGSHIP)
    labels = config.labels
    out = {}

    # 8a: the LM, its ARPA load and its device tables
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "synthetic_3gram.arpa")
        t0 = time.perf_counter()
        n_lines = synthetic_lm_arpa(path, labels, seed=9)
        write_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        lm = load_arpa(path)
        load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dlm = pack_device_lm(lm, labels, device="cuda")
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    if not (dlm.ng_table.is_cuda and dlm.voc_table.is_cuda):
        raise AssertionError("the device LM's tables are not on the card")
    t0 = time.perf_counter()
    host = BeamCTCDecoder(labels, lm_path=lm, alpha=LM_ALPHA, beta=LM_BETA,
                          beam_width=LM_BEAM, num_processes=6, cutoff_prob=1.0,
                          cutoff_top_n=40, blank_index=labels.index("_"))
    host_s = time.perf_counter() - t0
    if host._native is None:
        raise AssertionError("the host beam did not take its C++ route")
    counts = lm.num_ngrams()
    log(f"  synthetic 3-gram LM: n-gram counts {counts}, ARPA {size / 1e6:.1f} MB "
        f"({n_lines} lines, written in {write_s:.2f} s), load_arpa {load_s:.2f} s; "
        f"device tables {tuple(dlm.ng_table.shape)} + {tuple(dlm.voc_table.shape)} "
        f"int64 = {dlm.nbytes() / 1e6:.1f} MB packed in {pack_s:.2f} s; host C++ "
        f"decoder set up in {host_s:.2f} s")
    out["lm"] = {"ngrams": counts, "arpa_bytes": size, "load_s": load_s,
                 "pack_s": pack_s, "device_bytes": dlm.nbytes(), "host_setup_s": host_s}

    # 8b: the decoders on speech-like probabilities
    rows, t_max = 128, 401
    probs, _ = peaky_probs(np.random.default_rng(10), lm, labels, rows, t_max)
    lengths = np.full(rows, t_max, np.int32)
    probs_d = torch.from_numpy(probs).cuda()
    pointers = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = device_tops(probs_d, lengths, dlm, labels, keep_pointers=pointers)
    dev_s = time.perf_counter() - t0
    if not pointers or not all(p.is_cuda for group in pointers for p in group):
        raise AssertionError("the device beam's pointers are not on the card")
    t0 = time.perf_counter()
    cpu = device_tops(torch.from_numpy(probs), lengths, dlm.to("cpu"), labels)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hst = host_tops(host, probs, lengths, labels)
    hst_s = time.perf_counter() - t0
    log(f"  decoder check, B={rows} T={t_max} C={len(labels)} W={LM_BEAM}: device "
        f"beam on the card {dev_s:.2f} s, on the CPU {cpu_s:.2f} s, C++ host beam "
        f"(6 threads) {hst_s:.2f} s")
    out["decoders"] = {
        "card_vs_cpu": compare_tops("device beam: card vs CPU", dev, cpu, probs, lengths,
                                    dlm, labels, host_b=False),
        "card_vs_host": compare_tops("device beam on the card vs C++ host beam", dev, hst,
                                     probs, lengths, dlm, labels, host_b=True),
        "card_s": dev_s, "cpu_s": cpu_s, "host_threads_s": hst_s}
    if sum(" " in t for t in dev[0]) < rows // 2:
        raise AssertionError("the decoded rows hold no words")

    # 8c: the crossover, the decode alone at each batch size
    dev_dec = DeviceBeamDecoder(labels, beam_width=LM_BEAM, blank_index=labels.index("_"),
                                lm=dlm, alpha=LM_ALPHA, beta=LM_BETA)
    if dev_dec.lm is not dlm:
        raise AssertionError("the device decoder copied its LM")
    dev_dec.decode(probs_d[:2], lengths[:2], n_best=1)  # warm-up
    host_ms, dev_ms = {}, {}
    for b in CROSSOVER_BATCHES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev_dec.decode(probs_d[:b], lengths[:b], n_best=1)
        torch.cuda.synchronize()
        dev_ms[b] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        host.decode(probs[:b], lengths[:b])
        host_ms[b] = (time.perf_counter() - t0) * 1e3
        log(f"    B={b:3d}: host beam {host_ms[b]:9.1f} ms ({host_ms[b] / b:7.2f} ms a row), "
            f"device beam {dev_ms[b]:8.1f} ms ({dev_ms[b] / b:7.2f} ms a row) "
            f"[T={t_max}, {card}]")
    crossover = crossover_of(host_ms, dev_ms)
    log(f"  crossover: {crossover if crossover else 'none up to 128'} (the port's "
        f"DEFAULT_CROSSOVER is {beam_auto.DEFAULT_CROSSOVER}) [{card}]")
    out["crossover"] = {"host_ms": host_ms, "device_ms": dev_ms, "measured": crossover,
                        "default": beam_auto.DEFAULT_CROSSOVER}
    del probs_d, dev_dec
    torch.cuda.empty_cache()

    # 8d: Recognizer end to end on the flagship, every backend
    t0 = time.perf_counter()
    model = DeepSpeechModel.init_random(config, seed=0)
    rec = Recognizer(model=model)  # device=None: CUDA
    eng = rec.danspeech_recognizer
    log(f"  flagship set up in {time.perf_counter() - t0:.1f} s")
    waves = seeded_waveforms(np.random.default_rng(8), 128)
    clip = load_audio_pcm16(os.path.join("tests", "data", "clip_mono.wav"))
    audio_s = sum(len(w) for w in waves) / RATE
    groups = len(eng._plan_groups(waves))
    serve, texts = {}, {}
    launches = 0
    for backend in ("greedy", "host", "device", "auto"):
        t0 = time.perf_counter()
        if backend == "greedy":
            rec.update_decoder(lm="greedy")
        else:
            rec.update_decoder(lm=lm, alpha=LM_ALPHA, beta=LM_BETA,
                               beam_width=LM_BEAM, backend=backend)
        setup_s = time.perf_counter() - t0
        dec = eng.decoder
        rec.recognize(clip)  # warm-up of this decoder
        gru_cuda.gru_bidi_fused.launches = 0
        zero_designs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = rec.recognize(clip)
        one_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        texts[backend] = rec.recognize_batch(waves)
        wall = time.perf_counter() - t0
        n = gru_cuda.gru_bidi_fused.launches
        expected = config.rnn_layers * (groups + 1)
        if n != expected:
            raise AssertionError(f"{backend}: {n} gru_bidi_fused launches, expected {expected}")
        require_persistent(gru_cuda.gru_bidi_fused, f"LM serving, {backend}")
        launches += n
        if not isinstance(one, str) or len(texts[backend]) != len(waves):
            raise AssertionError(f"{backend}: wrong result shape")
        if backend != "greedy":
            routes = {type(dec.for_batch(len(i))).__name__ if hasattr(dec, "for_batch")
                      else type(dec).__name__ for i, _ in eng._plan_groups(waves)}
            host_side = getattr(dec, "_host", dec)
            if isinstance(host_side, BeamCTCDecoder) and host_side._native is None:
                raise AssertionError(f"{backend}: the host beam lost its C++ route")
            device_side = getattr(dec, "_device", dec)
            if isinstance(device_side, DeviceBeamDecoder) and not device_side.lm.ng_table.is_cuda:
                raise AssertionError(f"{backend}: the device LM is not on the card")
        else:
            routes = {"GreedyDecoder"}
        serve[backend] = {"audio_s": audio_s, "wall_s": wall, "audio_s_per_s": audio_s / wall,
                          "recognize_1s_ms": one_s * 1e3, "decoder_setup_s": setup_s,
                          "gru_bidi_fused_launches": n, "routes": sorted(routes)}
        log(f"  {backend}: recognize_batch of {len(waves)} ({audio_s:.1f} audio-s, "
            f"{groups} dispatch groups) {wall:.3f} s = {audio_s / wall:.1f} audio-s/s; "
            f"recognize(1 s clip) {one_s * 1e3:.1f} ms; gru_bidi_fused launches {n} "
            f"(expected {expected} = {config.rnn_layers} x {groups + 1} groups); "
            f"decoders {sorted(routes)}; set up in {setup_s:.2f} s [{card}]")
        if backend == "device":
            out["profile"] = profile_call("one LM recognize_batch, device beam",
                                          lambda: rec.recognize_batch(waves),
                                          groups=LM_PROFILE_GROUPS)
    # host, device and auto agree row for row, or flip at a near tie
    flips = 0
    for other in ("device", "auto"):
        for i, (a, b) in enumerate(zip(texts["host"], texts[other])):
            if a == b:
                continue
            p, n = group_probs(eng, waves, i)
            compare_tops(f"e2e {other} vs host, row {i}", device_tops(p, [n], dlm, labels),
                         host_tops(host, p.cpu().numpy(), [n], labels), p, [n], dlm,
                         labels, host_b=True)
            flips += 1
    log(f"  host, device and auto transcripts: {flips} rows differ at near ties")
    out["serve"] = serve
    out["e2e_flips"] = flips
    del rec, eng, model
    torch.cuda.empty_cache()

    # 8e: streaming with the LM and no secondary model
    sconfig = DeepSpeechConfig(**GPU_STREAMING)
    smodel = DeepSpeechModel.init_random(sconfig, seed=2)
    srec = Recognizer(model=smodel)
    seng = srec.danspeech_recognizer
    srec.update_decoder(lm=lm, alpha=LM_ALPHA, beta=LM_BETA, beam_width=LM_BEAM)
    seng.enable_streaming(secondary_model=None, return_string_parts=True)
    calls, _ = record_calls(seng)
    seen = []
    decode = seng.decoder.decode

    def recorded(p, sizes=None, n_best=None):
        seen.append((p, sizes))
        return decode(p, sizes, n_best=n_best)

    seng.decoder.decode = recorded
    audio = (np.random.default_rng(6).normal(size=8 * RATE) * 3000.0).astype(np.float32)
    plan = accumulate(audio, sconfig.context)
    gru_cuda.gru_scan.launches = 0
    zero_designs()
    chunk_ms, final = [], ""
    for chunk, first, last in plan:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = seng.streaming_transcribe(chunk, is_last=last, is_first=first)
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
    scan = gru_cuda.gru_scan.launches
    steps = frame_steps(calls, sconfig.audio_conf)
    if scan != sconfig.rnn_layers * len(steps):
        raise AssertionError(f"streaming with the LM: {scan} gru_scan launches, expected "
                             f"{sconfig.rnn_layers * len(steps)}")
    require_persistent(gru_cuda.gru_scan, "streaming with the LM")
    if len(seen) != 1:
        raise AssertionError("the final chunk did not re-decode with the LM")
    kept, sizes = seen[0]
    ref = DeviceBeamDecoder(labels, beam_width=LM_BEAM, blank_index=labels.index("_"),
                            lm=dlm, alpha=LM_ALPHA, beta=LM_BETA)
    again = ref.decode(kept, sizes, n_best=1)[0][0][0]
    log(f"  streaming with the LM: {len(plan)} chunks, gru_scan launches {scan}; the "
        f"final chunk (the LM re-decode of {kept.shape[1]} frames by "
        f"{type(seng.decoder.for_batch(1)).__name__}) {chunk_ms[-1]:.1f} ms, steady chunk "
        f"median {sorted(chunk_ms[1:-1])[len(chunk_ms[1:-1]) // 2]:.1f} ms [{card}]")
    if final != again:
        d = device_tops(torch.from_numpy(kept).cuda(), [kept.shape[1]], dlm, labels)
        compare_tops("streaming: the device beam vs the final", d,
                     host_tops(host, kept, [kept.shape[1]], labels), kept,
                     [kept.shape[1]], dlm, labels, host_b=True)
    else:
        log("  streaming final equals the device beam's decode of the same probabilities")
    out["stream"] = {"final_chunk_ms": chunk_ms[-1], "chunk_ms": chunk_ms,
                     "frames": int(kept.shape[1]), "gru_scan_launches": scan,
                     "equal_to_device_beam": final == again}
    out["launches"] = {"gru_bidi_fused": launches, "gru_scan": scan}
    return out


# ---------------------------------------------------------------------------
# --phase-clocks: where a step of the persistent kernels spends its clocks
# ---------------------------------------------------------------------------

# the sums csrc/persist.cuh keeps when built with -DPS_PROFILE (PS_ACC(i)):
# a step is barrier + prefetch + product + epilogue + other; the product is
# the wait for chunks + the MMAs + the drain + the store of the partial sums
PHASE_CLOCKS = {1: "grid barrier", 2: "prefetch of the next step's streams", 9: "product",
                5: "  of it: waiting for a chunk", 10: "  of it: issuing the wgmmas",
                11: "  of it: waiting for the chunk before's wgmmas",
                6: "  of it: leaving the stage",
                7: "  of it: drain", 8: "  of it: partial sums to shared memory",
                3: "epilogue", 0: "other"}


def phase_clocks(card):
    """Builds the seven persistent kernels' sources with -DPS_PROFILE into a
    build directory of their own, runs the persistent kernels once at the
    flagship, the 2000-wide, the streaming, the bidi batch and the LSTM and
    tanh-RNN serving and training shapes, and prints the clocks that thread
    0 of block 0 spent per step in each part (the instrumented build is a
    little slower than the plain one). The tanh pairs run once more with
    wider slices on fewer blocks, the plan's knob, to compare within the
    call."""
    import ctypes

    from danspeech_tpu_torch.ops import cuda_build, gru_cuda, lstm_cuda, persist_plan, rnn_tanh_cuda

    cuda_build.NVCC_FLAGS.append("-DPS_PROFILE")
    cuda_build.BUILD_DIR = os.path.join(cuda_build.BUILD_DIR, "profile")
    cuda_build.build("gru_bidi_fused", "gru_bwd", "gru_scan", "lstm_scan", "lstm_bwd",
                     "rnn_tanh_scan", "rnn_tanh_bwd")

    def read(lib):
        fn = cuda_build.load(lib).persist_prof_read
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        buf = (ctypes.c_ulonglong * 16)()
        rc = fn(ctypes.cast(buf, ctypes.c_void_p), 1)
        if rc != 0:
            raise RuntimeError(f"persist_prof_read failed: CUDA error {rc}")
        return list(buf)

    def report(tag, lib, fn, steps):
        fn()
        torch.cuda.synchronize()
        read(lib)
        ms = time_ms(fn, iters=1, warmup=0)
        sums = read(lib)
        step = sum(sums[i] for i in (0, 1, 2, 3, 9))
        log(f"  {tag}: {ms:.3f} ms a call, {step / steps:.0f} clocks a step [{card}]")
        for i, name in PHASE_CLOCKS.items():
            log(f"    {name:40s} {sums[i] / steps:9.0f} clocks a step "
                f"{100 * sums[i] / max(step, 1):5.1f}%")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t = 401
    for b in (128, 32):
        lengths = np.random.default_rng(1200).integers(1, 402, size=b)
        lengths[0], lengths[1] = 401, 1
        args = gru_layer_inputs(gen, t, b, 1200, 1200, lengths.tolist())
        report(f"gru_bidi_fused T={t} B={b} D=1200 H=1200", "gru_bidi_fused",
               lambda: gru_cuda.gru_bidi_fused(*args, design="persistent"), t)
        del args
    for h in (1200, 2000):
        lengths = np.random.default_rng(h + 1).integers(1, 402, size=32)
        lengths[0], lengths[1] = 401, 1
        args = bwd_inputs(gen, t, lengths.tolist(), h)
        report(f"gru_bwd_scan T={t} B=32 H={h}", "gru_bwd",
               lambda: gru_cuda.gru_bwd_scan(*args, reverse=True, design="persistent"), t + 1)
        if h == 1200:
            other = bwd_inputs(gen, t, lengths.tolist(), h, lens=args[3])
            report(f"gru_bwd_scan_pair T={t} B=32 H={h}", "gru_bwd",
                   lambda: gru_cuda.gru_bwd_scan_pair(args, other, True, False), t + 1)
            del other
        del args
    # B1 at the uni batch layer and the streaming chunk (steps walked: the
    # longest length)
    uni_lengths = np.random.default_rng(2000).integers(1, 402, size=128)
    uni_lengths[0] = 401
    for label, tt, lengths in (("uni batch layer", t, uni_lengths.tolist()),
                               ("streaming step", STREAM_T, [STREAM_VALID])):
        args = scan_inputs(gen, tt, lengths, 2000, carried=True)
        report(f"gru_scan {label} T={tt} B={len(lengths)} H=2000", "gru_scan",
               lambda: gru_cuda.gru_scan(*args, design="persistent"), max(lengths))
        del args
    # B5 as a pair at the LSTM serving layer
    serve = np.random.default_rng(800).integers(1, 402, size=128)
    serve[0] = 401
    chain_a = lstm_inputs(gen, t, serve.tolist(), 800)
    chain_b = lstm_inputs(gen, t, serve.tolist(), 800, lens=chain_a[1])
    report(f"lstm_scan_pair T={t} B=128 H=800", "lstm_scan",
           lambda: lstm_cuda.lstm_scan_pair(chain_a, chain_b, False, True), t)
    del chain_a, chain_b
    # B2 as a pair at the bidi batch layer (steps walked: the longest length)
    bidi = np.random.default_rng(1200).integers(1, 402, size=128)
    bidi[0] = 401
    fwd = scan_inputs(gen, t, bidi.tolist(), 1200, carried=True)
    bwd = scan_inputs(gen, t, bidi.tolist(), 1200, carried=True)
    report(f"gru_scan_bidi T={t} B=128 H=1200", "gru_scan",
           lambda: gru_cuda.gru_scan_bidi(fwd[0], bwd[0], fwd[1], fwd[2], bwd[2], fwd[3],
                                          bwd[3], fwd[4], bwd[4], fwd[5], bwd[5],
                                          design="persistent"), t)
    del fwd, bwd
    # B7 as a pair at the LSTM training layer (T + 1 steps)
    train = np.random.default_rng(801).integers(1, 402, size=32)
    train[0] = 401
    lens = torch.tensor(train.tolist(), dtype=torch.int32, device="cuda")

    def walk():
        h = 800
        w = ((torch.rand(h, 4 * h, generator=gen, device="cuda") * 2 - 1) / h ** 0.5)
        return ((torch.randn(t, 32, 4 * h, generator=gen, device="cuda") * 0.5).to(
                    torch.bfloat16),
                (torch.rand(t, 32, h, generator=gen, device="cuda") * 2 - 1).to(torch.bfloat16),
                torch.randn(t, 32, h, generator=gen, device="cuda").to(torch.bfloat16),
                torch.randn(t, 32, h, generator=gen, device="cuda"), lens,
                w.to(torch.bfloat16), torch.zeros(4 * h, device="cuda"))

    walk_a, walk_b = walk(), walk()
    report(f"lstm_bwd_scan_pair T={t} B=32 H=800", "lstm_bwd",
           lambda: lstm_cuda.lstm_bwd_scan_pair(walk_a, walk_b, True, False), t + 1)
    del walk_a, walk_b
    # B8 as a pair at the tanh serving layer (steps walked: the longest
    # length), B9 as a pair at the tanh training layer (T + 1 steps)
    serve_lens = torch.tensor(serve.tolist(), dtype=torch.int32, device="cuda")

    def tanh_weights(h=800):
        return ((torch.rand(h, h, generator=gen, device="cuda") * 2 - 1) / h ** 0.5).to(
            torch.bfloat16)

    def tanh_chain():
        return ((torch.randn(t, 128, 800, generator=gen, device="cuda") * 0.5).to(
                    torch.bfloat16), serve_lens, tanh_weights())

    def tanh_walk():
        out = (torch.rand(t, 32, 800, generator=gen, device="cuda") * 2 - 1).to(torch.bfloat16)
        out[torch.arange(t, device="cuda")[:, None] >= lens[None, :].long()] = 0
        return (out, torch.randn(t, 32, 800, generator=gen, device="cuda"), lens,
                tanh_weights())

    # each at the plan's slices (SM budget: the card's), then at the plan's
    # knob, wider slices on fewer blocks (the plans for 80 and 66 SMs)
    _, smem_optin = gru_cuda.device_info(torch.device("cuda", torch.cuda.current_device()))
    budgets = (torch.cuda.get_device_properties(0).multi_processor_count, 80, 66)
    chain_a, chain_b = tanh_chain(), tanh_chain()
    for sms in budgets:
        plan = persist_plan.plan_rnn_tanh_forward(800, 128, 2, sms, smem_optin)
        report(f"rnn_tanh_scan_pair T={t} B=128 H=800, {plan.units} units x "
               f"{plan.blocks_per_dir} blocks a chain", "rnn_tanh_scan",
               lambda: rnn_tanh_cuda._scan_persistent([chain_a, chain_b], [False, True], plan),
               t)
    del chain_a, chain_b
    walk_a, walk_b = tanh_walk(), tanh_walk()
    for sms in budgets:
        plan = persist_plan.plan_rnn_tanh_backward(800, 32, 2, sms, smem_optin)
        report(f"rnn_tanh_bwd_scan_pair T={t} B=32 H=800, {plan.units} units x "
               f"{plan.blocks_per_dir} blocks a chain", "rnn_tanh_bwd",
               lambda: rnn_tanh_cuda._bwd_persistent([walk_a, walk_b], [True, False], plan),
               t + 1)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true",
                    help="run phases 1-3 only (build and kernel checks)")
    ap.add_argument("--lm-serving", action="store_true",
                    help="run phases 1, 2 and 8 only (build, then serving with an LM)")
    ap.add_argument("--phase-clocks", action="store_true",
                    help="instead of the phases: build the persistent kernels with "
                         "-DPS_PROFILE and print where a step spends its clocks")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this check runs on the card",
              file=sys.stderr)
        return 1
    from danspeech_tpu_torch.ops import cuda_build, gru_cuda

    # phase 1
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    if args.phase_clocks:
        phase_clocks(card)
        return 0

    # phase 2
    t0 = time.perf_counter()
    build_logs = cuda_build.build(*sorted(
        f[:-3] for f in os.listdir(cuda_build.CSRC_DIR) if f.endswith(".cu")))
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    if args.lm_serving:
        log("phase 8: serving with a language model (host, device and auto beams)")
        lm_run = phase_lm(card)
        log(card)
        print(json.dumps({"lm_serving": lm_run}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # phase 3
    log("phase 3: the grid barrier alone, then kernels vs plain versions")
    barrier = phase_barrier()
    gru_checks = phase_kernels()
    scan_checks = phase_scan_kernels()
    bidi_checks = phase_scan_bidi_kernels()
    bwd_checks = phase_bwd_kernels()
    routes = phase_gru_layer_routes()
    rnn_type_checks = phase_rnn_type_kernels()

    launches = {}  # per kernel, summed over the main paths of phases 4-7
    pair_launches = {}  # paired launches of the wrappers that count chains, on those paths
    if not args.kernels:
        log("phase 4: batch path (Recognizer on the flagship)")
        served = phase_serve(card)
        log("phase 5: streaming path (GPUStreamingRNN, flagship secondary)")
        streamed = phase_stream(card)
        log("phase 6: training path (flagship train steps, uni steps, the loop)")
        trained = phase_train(card)
        log("phase 7: LSTM5x800 and Tanh5x800, served and trained")
        lstm_run = phase_rnn_type(card, LSTM5X800, train_steps=3, profile=True, loop=True)
        tanh_run = phase_rnn_type(card, TANH5X800, train_steps=2, profile=True, loop=False)
        log("phase 8: serving with a language model (host, device and auto beams)")
        lm_run = phase_lm(card)
        pair_launches = {**lstm_run["pair_launches"], **tanh_run["pair_launches"]}
        launches = {
            "gru_bidi_fused": served["launches"] + streamed["bidi_launches"]
            + trained["launches"]["gru_bidi_fused"] + lm_run["launches"]["gru_bidi_fused"],
            "gru_scan": streamed["scan_launches"] + trained["launches"]["gru_scan"]
            + lm_run["launches"]["gru_scan"],
            "gru_scan_bidi": routes["launches"],
            "gru_bwd_scan": trained["launches"]["gru_bwd_scan"],
        }
        for name in ("lstm_scan", "lstm_scan_with_cell", "lstm_bwd_scan"):
            launches[name] = lstm_run["launches"][name]
        for name in ("rnn_tanh_scan", "rnn_tanh_bwd_scan"):
            launches[name] = tanh_run["launches"][name]
        for name, n in launches.items():
            if not n:
                raise AssertionError(f"{name} was launched no time on the main paths")

    def entry(name, checks, main_label):
        main = next(c for c in checks if c.get("label") == main_label)
        extra = {k: main[k] for k in (
            "library_fp16_ms", "design", "step_ms", "step_design_ms", "recurrence_ms",
            "walk_ms", "projection_ms", "projection_tflops", "recompute_ms",
            "recompute_tflops", "pair_ms_per_chain", "pair_kernel_ms", "plan") if k in main}
        return {
            **extra,
            "name": name, "route": "cuda",
            "source": f"danspeech_tpu_torch/csrc/{SOURCES[name]}.cu",
            "replaces": f"danspeech_tpu/ops/pallas_gru.py:{REPLACES[name]}",
            "launches": launches.get(name),
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "shapes": checks,
        }

    next(c for c in gru_checks if c["shape"]["D"] == 2016)["label"] = "flagship layer 0"
    kernels = [
        entry("gru_bidi_fused", gru_checks, "flagship layer 0"),
        entry("gru_scan", scan_checks, "uni batch layer"),
        entry("gru_scan_bidi", bidi_checks, "bidi batch layer"),
        entry("gru_bwd_scan", bwd_checks, "flagship layer"),
        entry("lstm_scan", rnn_type_checks["lstm_scan"], "serve layer"),
        entry("lstm_scan_with_cell", rnn_type_checks["lstm_scan_with_cell"], "train layer"),
        dict(entry("lstm_bwd_scan", rnn_type_checks["lstm_bwd_scan"], "train layer"),
             pair_launches=pair_launches.get("lstm_bwd_scan")),
        dict(entry("rnn_tanh_scan", rnn_type_checks["rnn_tanh_scan"], "serve layer"),
             pair_launches=pair_launches.get("rnn_tanh_scan")),
        dict(entry("rnn_tanh_bwd_scan", rnn_type_checks["rnn_tanh_bwd_scan"], "train layer"),
             pair_launches=pair_launches.get("rnn_tanh_bwd_scan")),
    ]
    if not args.kernels:
        print(json.dumps({"lm_serving": lm_run}))
    log(card)  # as nvidia-smi prints it: name, power limit
    print(json.dumps({"kernels": kernels, "barrier_us": barrier["us"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
