#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (danspeech_tpu_torch).

    python3 chip_smoke.py            # every phase, needs one CUDA card
    python3 chip_smoke.py --kernels  # phases 1-3 only (build + kernel checks)
    python3 chip_smoke.py --only 8  # phases 1, 2 and 8 only (or 9, 10, 11, 12)
    python3 chip_smoke.py --phase-clocks  # where a persistent kernel's step
                                          # spends its clocks (-DPS_PROFILE build)
    python3 chip_smoke.py --lookahead  # phases 1, 2 and 11c only
    python3 chip_smoke.py --b5-h1024  # phases 1, 2 and 3b only
    python3 chip_smoke.py --b5-h2048  # phases 1, 2 and 3c only
    python3 chip_smoke.py --f32-train  # phases 1, 2 and phase 12g's float32
                                       # train steps alone, each step split,
                                       # unchecked: runs on an older tree too,
                                       # and prints no device line

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi; no power limit fails the
   run), torch and CUDA versions; every JSON line that carries times also
   carries them as ``"card"``;
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
   routes that reach ``gru_scan_bidi``; then (3b) ``lstm_scan`` at the LSTM
   layer of deepspeech.pytorch's bidirectional DeepSpeech2, H = 1024, T =
   1000 and B = 16, 32 and 128, as a pair beside cuDNN's bidirectional
   ``nn.LSTM``; phase 3 runs with TF32 off (the plain
   versions in full float32) and puts the process's flags back after it;
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
   seeded batch of 32 waveforms of 1-8 s with their launch counts, each
   launch a pair of chains (``ops/walks.py`` counts launches, and
   ``lstm_scan_with_cell``'s persistent ones on ``lstm_scan``: per LSTM step
   10 ``lstm_scan`` and 5 ``lstm_bwd_scan``; per tanh step 10
   ``rnn_tanh_scan`` and 5 ``rnn_tanh_bwd_scan``; a dispatch group 5
   ``lstm_scan`` or ``rnn_tanh_scan``), the gradients of an 8-row batch against
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
9. the rest of the single-GPU surface: the flagship written as a zip
   ``.pth`` package in the original layout and loaded through
   ``pretrained_models.CustomModel`` (its size and load time; its
   probabilities bit-equal and its transcripts equal to the in-memory
   model's over phase 4's 128 waveforms), a small legacy-format package;
   ``transfer_format="ulaw"``: the engine's decode of all 256 codes on the
   card against the table, transcripts equal to the int16 path fed the
   mu-law round-tripped audio, probabilities within PROB_ATOL, the
   throughput of both; ``MultiStreamTranscriber`` on GPUStreamingRNN in
   cohorts of S = 1, 8, 9, 64, 65 and 128 streams (seeded chunks of 6240
   samples), every step's probabilities against the same cohort on the
   plain GRU, the B1 plan each S takes (the CUDA-core product up to 8
   rows, the wgmma ring above, a second row block of 64 above 64 rows),
   the S = 9 streams each against the single-stream engine, the steady
   step's wall time, its host parse and the streams kept in real time, a
   profile of 3 steady steps at S = 128, and an S = 8 cohort whose final
   re-decodes with the synthetic 3-gram; ``Recognizer.streaming`` over
   phase 5's WAV read at a microphone's pace, the phrase's transcript
   against ``recognize`` of its samples; one ``{"surface": ...}`` line;
10. parallelism (``danspeech_tpu_torch/parallel``, ``decode/dist_beam.py``):
    at world size 1 (``make_mesh()``: this process alone, NCCL on cuda:0),
    ``ShardedTranscriber`` on the flagship over phase 4's 128 waveforms
    (transcripts equal ``recognize_batch``'s in one dispatch group, every
    row against the plain GRU), ``PipelinedTranscriber`` with three stages
    on cuda:0 against it, ``Recognizer.recognize_long_form`` on a seeded
    60 s waveform on the flagship (9 ``gru_scan_bidi`` launches, counted on
    ``gru_scan``, whose kernel they are) and on
    GPUStreamingRNN (5 ``gru_scan``), each against ``forward`` on the plain
    GRU, and the sharded beam (phase 8's 3-gram, B=8, T=401, beam 64)
    against the device beam; then two spawned gloo ranks on cuda:0
    (exchanges staged through host memory): the same long forms (per rank
    18 and 5 ``gru_scan`` launches) against world size 1, TP direction mode
    (9 ``gru_scan`` a rank) and hidden mode against ``forward``, the sharded
    beam against world size 1, and one data-parallel train step of the
    flagship at B=32 (16 rows a rank) against one rank on all 32 rows (loss
    within 1e-3 relative, gradients within 5e-2 relative L2 per group). The
    fc weights are scaled x128 (``COHORT_HEAD_GAIN``) and every row is held
    on its own; one ``{"parallel": ...}`` line;
11. the gallery: (a) ``batched_log_spectrogram`` of phase 4's 128
    waveforms with the rFFT and with the matmul DFT (C4: the share beyond
    5e-4, the 99.9th percentile and the largest difference bounded; the DFT
    bit-equal with TF32 allowed in the process), ``magnitude_stft`` and
    ``streaming_log_spectrogram`` on one row, each timed; the three conv
    layouts of ``ops/conv.py`` against ``F.conv2d`` (cuDNN) at the
    flagship's conv shapes, B=128, 801 input frames, in bf16 and in float32
    with TF32 allowed and off, each checked and timed; (b) the eight twins
    of ``danspeech_tpu_torch/examples`` through ``main(argv)`` on CUDA over seeded inputs in a temp dir (phase
    4's 128 waveforms as WAVs, phase 9's flagship ``.pth`` with fc x128,
    phase 8's 3-gram as ARPA, a 60 s recording of bursts, a 32-row
    manifest): ``batch_serving``, ``run_recognize``,
    ``video_transcribe_simulation`` and ``train_finetune`` (2 layers frozen,
    one epoch at B=32, then ``run_recognize`` of the export) on the
    flagship, the others at their demo widths; each twin's output equal to
    the port's API called directly on the same model and rows, its wall time
    and the launches read around it (B1, B2, B3 and B4 must each be
    launched); one ``{"gallery": ...}`` line; (c) the lookahead stencil
    (``csrc/lookahead.cu``) alone at GPUStreamingRNN's batch shape (T=401,
    B=128, H=2000, C=20), float32 with TF32 off: forward and past walk (dx)
    against the stacked plain version within LOOKAHEAD_RTOL, timed beside
    the plain version, one ``F.conv1d(groups=H)`` and the byte bound, the
    gradient's tap passes (dw) timed, ragged shapes on the scalar path; one
    ``{"lookahead": ...}`` line, with the stencil's launches in phase 4 (0:
    the flagship is bidirectional) and phase 5a (one a dispatch group,
    checked there);
12. float32 on the card, in a process that allows TF32 (matmul precision
    "high", cuDNN TF32 on, as a user's may): a product and a convolution
    whose results TF32 would change show that ``ops/precision.py`` turns it
    off; (a) each float32 entry of B1-B4 (``csrc/gru_f32.cu``) against its
    plain version (TF32 off) at ragged small shapes (H = 72 and 100, T = 1,
    a row of length 0, B = 150, reverse) and at the layer shapes
    (B3 T=401 B=128 H=1200 D=2016 and 1200; B1 T=401 B=128 H=2000 and the
    T=55 B=1 chunk; B2 H=1200 with carried states; B4 T=401 B=32 H=1200, one
    chain and the pair), B1, B2 and B3 in both designs (the persistent walk
    ``gru_f32_persist_kernel`` and the step kernel) and also at B = 8, 9,
    63, 64, 65, 128 (both sides of the plan's small-B switch and its tile
    and pass boundaries; T=55, carried states for B1 and B2), their layer
    shapes timed in both designs with µs a step by CUDA events (B3's walk
    alone through B2's entry on its projected gx), the profiler's kernel
    time with the launches it kept (none where it kept fewer than the call
    made), and the resident share, and one B1 call at the chunk split by
    the profiler (device time in the kernel against wall time) in each
    design; and of
    B5-B9 (``csrc/lstm_f32.cu``,
    ``csrc/rnn_tanh_f32.cu``) at ragged small shapes (H = 70, B = 150) and
    at LSTM5x800 / Tanh5x800's layer shapes (B5 and B8 T=401 B=128 H=800,
    B6, B7 and B9 T=401 B=32 H=800), one chain and a pair each, within
    F32_ATOL, in both designs (the persistent walks
    ``lstm_f32_persist_kernel``, ``lstm_f32_bwd_persist_kernel``,
    ``rnn_tanh_f32_persist_kernel`` and ``rnn_tanh_f32_bwd_persist_kernel``,
    and the step kernels), the layer shapes timed beside the plain version,
    one cuDNN float32 ``nn.GRU`` / ``nn.LSTM`` / ``nn.RNN`` call (TF32 off)
    and the FP32 bound; and the float32 GEMM of ``csrc/sgemm.cuh`` alone
    (``gru_cuda.sgemm_f32``) at the shapes of B3's projection and B4's and
    B7's recompute against ``torch.matmul`` in full float32 (SGEMM_REL), both
    timed; (b) ``Recognizer(compute_dtype="float32")`` on the flagship over
    phase 4's 128 waveforms (9 float32 B3 launches a dispatch group,
    audio-s/s beside bf16, every row against the plain GRU on the card, a few
    rows against the port on the CPU, transcripts equal up to near ties);
    (c) GPUStreamingRNN in float32: ``recognize_batch`` and
    ``streaming_transcribe`` over 8 s, every chunk against the plain GRU,
    and a ``MultiStreamTranscriber`` cohort of F32_COHORT streams (B1's
    float32 variant at B = S), every step against the same cohort on the
    plain GRU;
    (d) a 60 s long form of the flagship (9 float32 B2 launches); (e) two
    ``mixed_precision=False`` train steps of the flagship at B=32 (loss, wall
    time, peak memory) and the gradients of an 8-row batch against the plain
    path; (f) LSTM5x800 and Tanh5x800 loaded in float32 on CUDA, every
    weight float32; (g) each of them served (``recognize_batch`` of (b)'s
    waveforms, the launches by dtype, audio-s/s beside bf16, every row
    against the plain recurrence on the card, a few rows against the port
    on the CPU) and trained (two ``mixed_precision=False`` steps at B=32,
    8-row gradients against the plain path) as in (b) and (e), each train
    step split into the host time spent building or loading the kernels'
    libraries, the device time of the recurrent walks by CUDA events around
    each call, and the rest (beside them the garbage collector's time).
    Every float32 path is checked to run with TF32 off (its entry points
    record the flags), every float32 call of B1-B9 on (b)-(g) to take the
    persistent design (``design_counts``), each of the nine wrappers'
    float32 variants and the GEMM must be launched on phase 12's paths; one
    ``{"float32": ...}`` line;
13. one ``{"kernels": [...]}`` line of nine entries, each with a
    ``float32`` object, and the float32 GEMM beside them
    (``"float32_gemm"``), then the device line as the last line.

Imports no JAX and nothing of ``danspeech_tpu``.
"""

from __future__ import annotations

import argparse
import gc
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
# wrapper name -> the source of its float32 variant and the cuDNN module its
# float32 time is set beside
F32_SOURCES = {name: ("gru_f32", "nn.GRU") if name.startswith("gru")
               else ("lstm_f32", "nn.LSTM") if name.startswith("lstm")
               else ("rnn_tanh_f32", "nn.RNN(nonlinearity='tanh')") for name in SOURCES}
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
    """The card's name and power limit as nvidia-smi prints them; raises
    when the query returns no power limit, since every time this script
    prints is tied to it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    line = out[torch.cuda.current_device()] if out else ""
    limit = line.rpartition(",")[2].split()
    try:
        float(limit[0])
    except (IndexError, ValueError):
        raise AssertionError(f"nvidia-smi returned no power limit: {line!r}") from None
    return line


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


def read_chains() -> dict:
    return {name: w.chains for name, w in kernel_wrappers().items()}


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


def profile_events(fn, kernel: str | None = None, launches: int | None = None,
                   tries: int = 3) -> dict:
    """One call of ``fn`` under torch.profiler, as read: its wall time on
    the host (ms), its device events as (name, start µs, end µs), how many
    of them hold ``kernel`` in their name (all where it is None) and whether
    the reading is whole. Now and then the profiler loses some or all of a
    call's device events (a persistent walk read 0 ms beside its 6 ms by
    CUDA events; a call of 401 step launches kept 361 of them): a reading
    with no such event, or with other than ``launches`` of them where that
    is given, is taken again, up to ``tries`` calls in all. The last reading
    is returned as it is, ``whole`` False where it still falls short."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.time_range.end > e.time_range.start]
        count = len(events) if kernel is None else sum(kernel in e[0] for e in events)
        whole = count > 0 and (launches is None or count == launches)
        if whole:
            break
    return {"wall_ms": wall, "events": events, "count": count, "whole": whole}


def device_ms_by_kernel(fn, need: str | None = None, tries: int = 3) -> dict:
    """Device time of one call of ``fn`` by kernel name, ms, as
    :func:`profile_events` reads it (``need``: a kernel the reading must
    hold)."""
    out = {}
    for name, start, end in profile_events(fn, need, tries=tries)["events"]:
        out[name] = out.get(name, 0.0) + (end - start) / 1e3
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
    """The design counts and the chain counts of every wrapper to 0."""
    for w in kernel_wrappers().values():
        w.design_counts = dict.fromkeys(DESIGNS, 0)
        w.chains = 0


def phase_barrier():
    """The grid barrier of csrc/persist.cuh alone: a cooperative launch of
    one block per SM, each holding 200 KB of shared memory, that takes 2000
    barriers and checks after each that another block's write before it is
    visible. Returns the time of one barrier for a full grid and for the 50
    and 75 blocks that one chain of the flagship uses."""
    import ctypes

    from danspeech_tpu_torch.ops import cuda_build, walks

    fn = cuda_build.load("gru_bwd").persist_barrier_probe_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms, smem_optin = walks.device_info(torch.device("cuda", torch.cuda.current_device()))
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


def gru_layer_inputs(gen, t, b, d, h, lengths, dtype=torch.bfloat16):
    """Seeded operands of gru_bidi_fused: x and the weights in ``dtype``."""
    dev = "cuda"
    bound = 1.0 / h ** 0.5

    def uni(*shape):
        return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * bound

    x = torch.randn(t, b, d, generator=gen, device=dev).to(dtype)
    w_ih = [uni(d, 3 * h).to(dtype) for _ in range(2)]
    w_hh = [uni(h, 3 * h).to(dtype) for _ in range(2)]
    b_ih = [uni(3 * h) for _ in range(2)]
    b_hh = [uni(3 * h) for _ in range(2)]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return (x, lens, w_ih[0], w_ih[1], w_hh[0], w_hh[1],
            b_ih[0], b_ih[1], b_hh[0], b_hh[1])


def gru_bound(t, b, d, h, lengths):
    """(bound_ms, bound_by): the larger of the operations over the bf16
    peak and the bytes (each input read once, each output written once)
    over the memory rate, over the valid steps: a row past its length
    emits exact zeros and needs no projection or product."""
    valid = int(sum(lengths))
    flops = 2 * 2 * valid * (d + h) * 3 * h  # 2 directions, multiply-add = 2
    nbytes = (
        valid * d * 2                  # x bf16, the valid steps
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
    from danspeech_tpu_torch.ops import gru_cuda, persist_plan, walks

    args = gru_layer_inputs(gen, t, b, d, h, lengths)
    dev_info = walks.device_info(args[0].device)
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
        res["bound_ms"], res["bound_by"] = gru_bound(t, b, d, h, lengths)
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
    # the flagship's layer 0 at the dispatch groups' row counts beside 128:
    # what the scheduler's walk charge (engine.WIDE_BLOCK_STEP) rests on
    for b in (32, 64):
        lengths = np.random.default_rng(2016 + b).integers(1, 402, size=b)
        lengths[0], lengths[1] = 401, 1
        flag.append(check_gru(gen, 401, b, 2016, 1200, lengths.tolist(), timed=True))
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


def scan_inputs(gen, t, lengths, h, carried, dtype=torch.bfloat16):
    """Seeded operands of gru_scan: (gx, lengths, w_hh, b_ih, b_hh, h0), gx
    and w_hh in ``dtype``."""
    dev = "cuda"
    b = len(lengths)
    bound = 1.0 / h ** 0.5

    def uni(*shape):
        return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * bound

    gx = (torch.randn(t, b, 3 * h, generator=gen, device=dev) * 0.5).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    w_hh = uni(h, 3 * h).to(dtype)
    b_ih, b_hh = uni(3 * h), uni(3 * h)
    h0 = torch.zeros(b, h, device=dev)
    if carried:
        h0 = torch.rand(b, h, generator=gen, device=dev) - 0.5
    return gx, lens, w_hh, b_ih, b_hh, h0


def check_scan(gen, label, t, lengths, h, reverse, carried, timed):
    """gru_scan in both designs against its plain version; the plan must
    choose the persistent design at this shape."""
    from danspeech_tpu_torch.ops import gru_cuda, persist_plan, walks

    dev = "cuda"
    b = len(lengths)
    args = scan_inputs(gen, t, lengths, h, carried)
    gx, lens = args[:2]
    planned = persist_plan.plan_gru_scan(h, b, *walks.device_info(gx.device))
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
        if pad.any() and float(got[0][pad].float().abs().max()) != 0.0:
            raise AssertionError(f"gru_scan ({tag}): non-zero output past a row's length")
        errs, _ = compare_outputs(f"gru_scan ({tag}) {label}", ("out", "h_last"), got, ref,
                                  GRU_ATOL)
        log(f"  gru_scan[{tag}] {label} T={t} B={b} H={h} reverse={reverse} "
            f"h0={'carried' if carried else 'zero'}: max|err| "
            + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()) + f" (atol {GRU_ATOL})")
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
                    "row_blocks": planned.row_blocks, "k_splits": planned.k_splits, "stages": planned.stages,
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
                             False, carried=False, timed=True))
    # one 64-row block beside the batch layer's two (the scheduler's walk charge)
    half = np.random.default_rng(2002).integers(1, 402, size=64)
    half[0], half[1] = 401, 1
    checks.append(check_scan(gen, "uni B=64 layer", 401, half.tolist(), 2000,
                             False, carried=False, timed=True))
    checks.append(check_scan(gen, "streaming step", STREAM_T, [STREAM_VALID], 2000,
                             False, carried=True, timed=True))
    # the widest batch of the CUDA-core product (eight streams stepped together)
    checks.append(check_scan(gen, "streaming B=8", STREAM_T,
                             [STREAM_VALID, 20, STREAM_VALID, 1, STREAM_VALID, 0, 12, 34],
                             2000, False, carried=True, timed=False))
    # the multi-stream cohort's step (phase 9): a carried state on both sides
    # of the switch to the wgmma ring (B = 9) and of the second row block
    # (B = 65), every stream at the steady chunk's length but a few short
    # ones; the last row, alone in its block at B = 65, runs the whole chunk
    for b in (9, 64, 65, 128):
        lengths = [STREAM_VALID] * b
        lengths[1], lengths[b // 2] = 1, 17
        checks.append(check_scan(gen, f"cohort B={b}", STREAM_T, lengths, 2000, False,
                                 carried=True, timed=False))
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
    from danspeech_tpu_torch.ops import gru_cuda, walks

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
    planned, apart = walks.plan_of(gru_cuda.GRU_SCAN_BIDI, h, b, 2,
                                   walks.device_info(lens.device))
    if planned.design != "persistent":
        raise AssertionError(f"gru_scan_bidi H={h} B={b}: planned {planned}")
    layout = "one launch a chain" if apart else "both chains, one launch"
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
           "plan": {"pair": "step" if apart else "persistent", "units": planned.units,
                    "grid": planned.grid,
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
    """One cuDNN recurrent module (nn.GRU, nn.LSTM or nn.RNN of width H) in
    ``dtype`` on a (T, B, its input width) input: the time of its forward,
    or (unidirectional) with ``backward`` the time of forward plus backward
    less the time of the forward alone. It
    also computes the input projection, and its backward the weight and
    input gradients, which the port's kernels leave to their caller.

    cuDNN wants its weights in one block. ``flatten_parameters`` makes that
    block for float16 but leaves bf16 weights apart (PyTorch's
    ``cudnn.is_acceptable`` refuses the dtype), so a bf16 call compacts them
    every time and warns: the bf16 time is an upper bound of the library's."""
    rnn = module.to("cuda", dtype)
    rnn.flatten_parameters()
    x = torch.randn(t, b, rnn.input_size, generator=gen, device="cuda").to(dtype)
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


def bwd_inputs(gen, t, lengths, h, lens=None, dtype=torch.bfloat16):
    """Seeded operands of gru_bwd_scan: gx, hprev and w_hh in ``dtype``."""
    dev = "cuda"
    b = len(lengths)
    bound = 1.0 / h ** 0.5

    def uni(*shape):
        return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * bound

    gx = (torch.randn(t, b, 3 * h, generator=gen, device=dev) * 0.5).to(dtype)
    hprev = (torch.rand(t, b, h, generator=gen, device=dev) * 2 - 1).to(dtype)
    dout = torch.randn(t, b, h, generator=gen, device=dev)
    if lens is None:
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    w_hh = uni(h, 3 * h).to(dtype)
    b_ih, b_hh = uni(3 * h), uni(3 * h)
    dh_last = torch.randn(b, h, generator=gen, device=dev)
    return (gx, hprev, dout, lens, w_hh, b_ih, b_hh, dh_last)


def check_bwd(gen, label, t, lengths, h, reverse, timed, pair=True):
    """gru_bwd_scan in both designs, and gru_bwd_scan_pair (two chains in one
    persistent launch where the plan allows), against the plain version; the
    plan must choose the persistent design at this shape."""
    from danspeech_tpu_torch.ops import gru_cuda, persist_plan, walks

    dev = "cuda"
    b = len(lengths)
    args = bwd_inputs(gen, t, lengths, h)
    lens = args[3]
    dev_info = walks.device_info(args[0].device)
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
        before = (gru_cuda.gru_bwd_scan.launches, gru_cuda.gru_bwd_scan.chains)
        got_a, got_b = gru_cuda.gru_bwd_scan_pair(args, other, reverse, not reverse)
        torch.cuda.synchronize()
        one = pair_plan.design == "persistent"
        if (gru_cuda.gru_bwd_scan.launches - before[0],
                gru_cuda.gru_bwd_scan.chains - before[1]) != (1 if one else 2, 2):
            raise AssertionError(f"{name}: a pair must count its launches and two chains")
        tag = "pair, one launch" if one else "pair, two launches"
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
    from danspeech_tpu_torch.ops import lstm_cuda, persist_plan, rnn_tanh_cuda, walks

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

    dev_info = walks.device_info(lens.device)
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
    # B6's persistent launches are lstm_persist_kernel's, counted on lstm_scan
    owner = lstm_cuda.lstm_scan if kind == "lstm_scan_with_cell" else wrapper
    all_errs, worst = {}, 0.0
    for tag, run in runs.items():
        counter = wrapper if tag == "step" else owner
        before = (counter.launches, counter.chains)
        got = run()
        torch.cuda.synchronize()
        if (counter.launches - before[0], counter.chains - before[1]) \
                != (1, 2 if tag == "pair" else 1):
            raise AssertionError(f"{name} [{tag}]: expected one launch counted on "
                                 f"{counter.__name__}")
        if tag == "pair":
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


# B5 at the LSTM layer of deepspeech.pytorch's bidirectional DeepSpeech2 (H =
# 1024) and the dispatch groups of 2-20 s utterances: up to 1,000 frames, 16,
# 32, 64 or 128 rows
B5_H1024 = (1000, 1024, (16, 32, 64, 128))
B5_H1024_TITLE = "phase 3b: B5 (lstm_scan) at H = 1024, T = 1000, as a pair"


def phase_b5_h1024(card):
    """B5 (``lstm_scan``) at H = 1024, T = 1000 and B = 16, 32, 64 and 128, each
    batch with ragged lengths (the longest T, one of 1): held to its plain
    version in both designs and as a pair of chains in one launch, the
    served path (:func:`check_rnn_kernel`), timed beside the plain version
    and cuDNN's ``nn.LSTM`` in bf16, one direction and both (with its
    projection, as the library computes it); µs a step of the pair over the
    steps walked."""
    t, h, batches = B5_H1024
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1024)
    rows = []
    for b in batches:
        lengths = np.random.default_rng(1024 + b).integers(1, t + 1, size=b)
        lengths[0], lengths[1] = t, 1
        res = check_rnn_kernel("lstm_scan", gen, f"H=1024 B={b}", t, lengths.tolist(), h,
                               False, True)
        res["pair_us_a_step"] = 1e3 * res["pair_kernel_ms"] / t
        res["library_bidi_ms"] = cudnn_rnn_ms(torch.nn.LSTM(h, h, bidirectional=True), gen,
                                              t, b, h, backward=False)
        log(f"  B5 H={h} T={t} B={b}: a pair {res['pair_kernel_ms']:.3f} ms = "
            f"{res['pair_us_a_step']:.2f} us a step (one chain {res['step_ms'] * 1e3:.2f}); "
            f"cuDNN nn.LSTM bf16 one direction {res['library_ms']:.3f} ms, both "
            f"{res['library_bidi_ms']:.3f} ms; plain {res['plain_ms']:.1f} ms [{card}]")
        rows.append(res)
    return rows


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
    # B2's persistent launch of both chains is gru_scan_persist_kernel's,
    # counted on gru_scan: one launch of two chains a call
    zero_launches()
    zero_designs()
    with torch.no_grad():
        for label, kw in (("concat", dict(sum_directions=False)), ("carried h0", dict(h0=h0))):
            before = (gru_cuda.gru_scan.launches, gru_cuda.gru_scan.chains)
            got = gru_layer(x.float(), lens, fwd, bwd, **kw)
            torch.cuda.synchronize()
            if (gru_cuda.gru_scan.launches - before[0],
                    gru_cuda.gru_scan.chains - before[1]) != (1, 2):
                raise AssertionError(f"gru_layer({label}) did not walk both chains in one "
                                     "gru_scan_bidi launch")
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
    out["launches"] = gru_cuda.gru_scan.launches
    require_persistent(gru_cuda.gru_scan, "gru_layer routes to gru_scan_bidi")
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
    from danspeech_tpu_torch.ops import gru_cuda, lookahead_cuda

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
    lookahead_cuda.lookahead.launches = 0
    zero_designs()
    planned = dict(eng.plan_counts)
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
    planned = planned_since("flagship recognize + recognize_batch", eng, planned)
    launches = gru_cuda.gru_bidi_fused.launches
    log(f"  gru_bidi_fused launches on the main path: {launches} "
        f"(expected {expected} = {config.rnn_layers} layers x dispatch groups)")
    if launches != expected:
        raise AssertionError("the main path did not run every GRU layer on the kernel")
    require_persistent(gru_cuda.gru_bidi_fused, "flagship serving")
    stencils = lookahead_cuda.lookahead.launches
    log(f"  lookahead stencil launches on the flagship's path: {stencils} (expected 0: "
        f"bidirectional, no lookahead)")
    if stencils:
        raise AssertionError("a bidirectional model launched the lookahead stencil")
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
            "lookahead_launches": stencils, "profile": profile, "planned": planned,
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


def write_pcm(path, pcm):
    """Write samples at int16 scale as a 16 kHz 16-bit mono WAV."""
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(RATE)
        w.writeframes(np.clip(pcm, -32768, 32767).astype("<i2").tobytes())
    return path


def seeded_wav(path, rng):
    """1 s silence, 4 s speech-level noise, 2 s silence: 16-bit mono PCM."""
    speech = rng.normal(size=4 * RATE) * 3000.0
    pcm = np.concatenate([np.zeros(RATE), speech, np.zeros(2 * RATE)])
    write_pcm(path, pcm)
    return len(pcm)


STREAM_PROFILE_GROUPS = {
    "B1 recurrence": ("gru_scan_persist_kernel", "gru_scan_step_kernel"),
    "lookahead": ("lookahead_stencil_kernel",),
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
    from danspeech_tpu_torch.ops import gru_cuda, lookahead_cuda

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
    groups = sum(len(eng._plan_groups(b)) for b in batches)
    expected = layers * groups
    gru_cuda.gru_scan.launches = 0
    stencils0 = lookahead_cuda.lookahead.design_counts["stencil"]
    zero_designs()
    planned = dict(eng.plan_counts)
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
    planned = planned_since("uni recognize_batch", eng, planned)
    batch_launches = gru_cuda.gru_scan.launches
    log(f"  gru_scan launches on the uni batch path: {batch_launches} (expected "
        f"{expected} = {layers} layers x dispatch groups)")
    if batch_launches != expected:
        raise AssertionError("the uni batch path did not run every GRU layer on gru_scan")
    require_persistent(gru_cuda.gru_scan, "uni batch")
    stencils = lookahead_cuda.lookahead.design_counts["stencil"] - stencils0
    log(f"  lookahead stencil launches on the uni batch path: {stencils} (expected "
        f"{groups}, one a forward: a dispatch group)")
    if stencils != groups:
        raise AssertionError("the uni batch path did not run each forward's lookahead "
                             "on the stencil")
    out["batch"] = {"launches": batch_launches, "lookahead_launches": stencils,
                    "forwards": groups, "serve": serve, "planned": planned}
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


def seeded_manifest(tmp, rng, labels, n, hi_s=3.0):
    """``n`` seeded WAVs of 1 to ``hi_s`` s with seeded transcripts, and
    their manifest."""
    letters = [c for c in labels if c not in "_ "]
    lines = []
    for i, pcm in enumerate(seeded_waveforms(rng, n, 1.0, hi_s)):
        path = write_pcm(os.path.join(tmp, f"utt{i}.wav"), pcm)
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
    # with remat the forward kernel runs in the forward and again in the backward;
    # the two backward walks of a layer share one launch
    expect = dict(zero, gru_bidi_fused=2 * layers, gru_bwd_scan=layers)
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
    # + the recognize call), 4 x 2 directions backward in one launch a layer
    loop_counts = {"gru_bidi_fused": gru_cuda.gru_bidi_fused.launches,
                   "gru_bwd_scan": gru_cuda.gru_bwd_scan.launches}
    want_bwd = 4 * loop_cfg.rnn_layers
    log(f"  loop launches: {loop_counts} (expected gru_bwd_scan {want_bwd}, "
        f"{2 * want_bwd} chains)")
    if (loop_counts["gru_bwd_scan"], gru_cuda.gru_bwd_scan.chains) != (want_bwd, 2 * want_bwd) \
            or loop_counts["gru_bidi_fused"] <= 2 * want_bwd:
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
    and ``chains``, the chains those launches walked (two in each
    cooperative launch of a pair), summed the same way for the kernels whose
    launches walk pairs."""
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
    fwd = lstm_cuda.lstm_scan if lstm else rnn_tanh_cuda.rnn_tanh_scan
    # a layer's two chains are one launch (lstm_scan_pair, rnn_tanh_scan_pair)
    expect = dict(zero, **{fwd_kernel: layers * groups})
    rec.recognize_batch(batch[:4])  # warm-up: cuDNN picks its conv algorithms
    zero_launches()
    zero_designs()
    planned = dict(eng.plan_counts)
    t0 = time.perf_counter()
    text = rec.recognize(clip_audio)
    clip_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    texts = rec.recognize_batch(batch)
    wall = time.perf_counter() - t0
    counts = read_launches()
    planned = planned_since(f"{name} recognize + recognize_batch", eng, planned)
    if not isinstance(text, str) or len(texts) != len(batch) or not all(
            isinstance(t, str) for t in texts):
        raise AssertionError(f"{name}: recognize / recognize_batch returned the wrong shape")
    audio_s = sum(len(w) for w in batch) / RATE
    log(f"  {name} recognize({os.path.basename(clip)}): {clip_s * 1e3:.1f} ms; "
        f"recognize_batch: {audio_s:.2f} audio-s in {wall:.3f} s = "
        f"{audio_s / wall:.1f} audio-s/s; launches "
        + ", ".join(f"{a} {c}" for a, c in counts.items() if c)
        + f" (expected {fwd_kernel} {expect[fwd_kernel]} = {layers} layers x {groups} "
        f"dispatch groups, {fwd.chains} chains) [{card}]")
    if counts != expect or fwd.chains != 2 * layers * groups:
        raise AssertionError(f"{name} serve: launches {counts}, {fwd.chains} chains, "
                             f"expected {expect}, two chains a launch")
    require_persistent(fwd, f"{name} serving")
    walked = {fwd_kernel: fwd.chains}
    add(counts)
    out["serve"] = {"recognize_s": clip_s, "audio_s": audio_s, "wall_s": wall,
                    "audio_s_per_s": audio_s / wall,
                    "launches": counts, "dispatch_groups": groups, "chains": dict(walked),
                    "planned": planned}
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
        # keeps the cell streams (B6), each a pair of chains in one launch of
        # lstm_persist_kernel, counted on lstm_scan; one launch walks both
        # chains of a layer backward (B7)
        texpect = dict(zero, lstm_scan=2 * layers, lstm_bwd_scan=layers)
    else:
        # with remat both forwards run every layer's pair of chains in one
        # launch (B8), and one launch walks both chains of a layer (B9)
        texpect = dict(zero, rnn_tanh_scan=2 * layers, rnn_tanh_bwd_scan=layers)
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
        require_persistent(lstm_cuda.lstm_scan, f"{name} training, both forwards")
        require_persistent(lstm_cuda.lstm_bwd_scan, f"{name} training, backward walks")
        paired = {"lstm_scan": lstm_cuda.lstm_scan, "lstm_bwd_scan": lstm_cuda.lstm_bwd_scan}
    else:
        require_persistent(rnn_tanh_cuda.rnn_tanh_scan, f"{name} training, both forwards")
        require_persistent(rnn_tanh_cuda.rnn_tanh_bwd_scan, f"{name} training, backward walks")
        paired = {"rnn_tanh_scan": rnn_tanh_cuda.rnn_tanh_scan,
                  "rnn_tanh_bwd_scan": rnn_tanh_cuda.rnn_tanh_bwd_scan}
    for kernel, wrapper in paired.items():
        n = wrapper.chains
        log(f"  {name} training: {kernel} walked {n} chains over {train_steps} steps "
            f"(expected two a launch)")
        if n != 2 * texpect[kernel] * train_steps:
            raise AssertionError(f"{name}: {kernel} walked {n} chains, expected "
                                 f"{2 * texpect[kernel] * train_steps}")
        walked[kernel] = walked.get(kernel, 0) + n
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
        # (recomputed, counted on lstm_scan), both chains of the layer in it,
        # and one of B7 walking both; the recognize call adds one B5 per layer
        per = 2 * loop_cfg.rnn_layers
        want = dict(zero, lstm_scan=2 * per + loop_cfg.rnn_layers, lstm_bwd_scan=per)
        if counts != want:
            raise AssertionError(f"{name} loop: launches {counts}, expected {want}")
        if lstm:
            walked["lstm_bwd_scan"] += lstm_cuda.lstm_bwd_scan.chains
        add(counts)
        out["loop"] = {"launches": counts, "log": lines}

    out["launches"] = total
    out["chains"] = walked
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


def device_tops(probs, lengths, dlm, labels, keep_pointers=None, beam=LM_BEAM,
                alpha=LM_ALPHA, beta=LM_BETA):
    """The device beam's best transcript and its score per row (the
    published settings unless given), on ``probs``' device.
    ``keep_pointers`` (a list) receives the per-frame pointer tensors of the
    search."""
    from danspeech_tpu_torch.decode import device_beam

    real = device_beam.backtrack_beams

    def kept(pb, pnb, parents, chars, t_max, extra_scores=None, top=None):
        if keep_pointers is not None:
            keep_pointers.extend([parents, chars])
        return real(pb, pnb, parents, chars, t_max, extra_scores=extra_scores, top=top)

    device_beam.backtrack_beams = kept
    try:
        lab, _, lens, scores = device_beam.ctc_beam_search_device(
            probs, lengths, beam_width=beam, blank=labels.index("_"), lm=dlm,
            alpha=alpha, beta=beta, space=labels.index(" "), top=1)
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
# Phase 9: the rest of the single-GPU surface
# ---------------------------------------------------------------------------

# cohort sizes of the multi-stream step: both sides of the B1 plan's switch
# from the CUDA-core product to the wgmma ring (DOT_ROWS = 8) and of its
# second row block of 64 (above 64 rows)
COHORTS = (1, 8, 9, 64, 65, 128)
COHORT_CHUNK = 6240  # samples of a steady chunk at context 20: 390 ms of audio
COHORT_STEADY = 10  # about 400 frames a stream, over which its argmax agreement is held
# the cohort model's fc weights are scaled by this: a random head's softmax is
# almost flat (1e-5 flips its argmax), so a wrong state would stay under the
# probability bound; sharpened, it moves the probabilities by tenths. At
# 5x2000 a gain of 16 left the mean top probability at 0.039 (33 labels)
COHORT_HEAD_GAIN = 128.0


def reference_package(config, params):
    """A .pth package in the original layout: the hyperparameters that
    config_from_package reads beside a state_dict of CPU tensors, BatchNorm's
    num_batches_tracked included."""
    from danspeech_tpu_torch.models.checkpoint import state_dict_from_params

    sd = {}
    for k, v in state_dict_from_params(params, config).items():
        sd[k] = torch.from_numpy(v)
        if k.endswith("running_var"):
            sd[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return {"model_name": config.model_name, "rnn_hidden_size": config.rnn_hidden_size,
            "rnn_layers": config.rnn_layers, "labels": config.labels,
            "audio_conf": dict(config.audio_conf), "rnn_type": config.rnn_type,
            "bidirectional": config.bidirectional, "conv_layers": config.conv_layers,
            "context": config.context, "streaming_model": config.streaming_model,
            "state_dict": sd}


def require_equal_params(label, a, b):
    from danspeech_tpu_torch.models.checkpoint import state_dict_from_params

    sa, sb = state_dict_from_params(a.params, a.config), state_dict_from_params(b.params, b.config)
    if a.config.to_dict() != b.config.to_dict() or sorted(sa) != sorted(sb):
        raise AssertionError(f"{label}: the loaded config or keys differ")
    bad = [k for k in sa if not np.array_equal(sa[k], sb[k])]
    if bad:
        raise AssertionError(f"{label}: parameters differ: {bad[:5]}")


def group_forward(eng, waves):
    """The first dispatch group of ``waves`` staged by ``eng`` and run through
    its forward on the card: (probs, out_lens, real rows)."""
    idxs, maxlen = eng._plan_groups(waves)[0]
    staged, lengths = eng._stage_group(waves, idxs, maxlen)
    probs, out_lens = eng._forward(eng._compute_params, staged.to("cuda"),
                                   torch.from_numpy(lengths).to("cuda"))
    torch.cuda.synchronize()
    return probs, out_lens, len(idxs), staged


def planned_since(label, eng, before):
    """What ``eng``'s batch scheduler planned since ``before`` (a copy of its
    ``plan_counts``), logged and returned."""
    got = {k: eng.plan_counts[k] - before[k] for k in before}
    log(f"  {label}: the scheduler planned {got['calls']} calls, {got['groups']} "
        f"dispatch groups, {got['rows']} rows, {got['padded_row_s']:.1f} padded row-s, "
        f"{got['walked_s']:.1f} s walked a layer")
    return got


def timed_batch(rec, waves):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts = rec.recognize_batch(waves)
    wall = time.perf_counter() - t0
    return texts, wall


def cohort_chunks(n_streams):
    """Stream s's chunks, the same in every cohort: a first chunk,
    COHORT_STEADY steady ones and a last one, each COHORT_CHUNK samples of
    speech-level noise from seed 100 + s."""
    n = COHORT_STEADY + 2
    return [(np.random.default_rng(100 + s).normal(size=n * COHORT_CHUNK) * 3000.0)
            .astype(np.float32).reshape(n, COHORT_CHUNK) for s in range(n_streams)]


def record_probs(decoder, sink):
    """Wrap a greedy decoder's decode so that every host copy of the
    probabilities it reads is kept."""
    decode = decoder.decode

    def recorded(probs, *a, **k):
        sink.append(np.array(probs, copy=True))
        return decode(probs, *a, **k)

    decoder.decode = recorded


def run_cohort(ms, streams, timed=False, parse_ms=None):
    """One epoch of a cohort: every chunk index stepped once. Returns
    (the last step's finals, the wall ms of each step)."""
    if parse_ms is not None:
        for parser in ms.parsers:
            parse = parser.parse_audio

            def timed_parse(*a, _parse=parse, **k):
                t0 = time.perf_counter()
                out = _parse(*a, **k)
                parse_ms.append((time.perf_counter() - t0) * 1e3)
                return out

            parser.parse_audio = timed_parse
    n = len(streams[0])
    step_ms, out = [], None
    for i in range(n):
        if timed:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ms.step([st[i] for st in streams], is_last=i == n - 1, is_first=i == 0)
        if timed:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return out, step_ms


def step_stats(label, got, ref):
    """Every step's (S, T, C) probabilities of two runs: the largest
    difference at any step, and per stream the frames whose argmax agrees
    over the whole run."""
    if len(got) != len(ref) or not got:
        raise AssertionError(f"{label}: {len(got)} steps against {len(ref)}")
    worst, agree, frames = 0.0, 0, 0
    for k, (p, r) in enumerate(zip(got, ref)):
        if p.shape != r.shape or not np.isfinite(p).all():
            raise AssertionError(f"{label}, step {k}: shapes {p.shape} {r.shape} "
                                 "or non-finite values")
        worst = max(worst, float(np.abs(p - r).max()))
        agree = agree + (p.argmax(-1) == r.argmax(-1)).sum(axis=1)
        frames += p.shape[1]
    per_stream = np.asarray(agree) / frames
    return {"steps": len(got), "streams": len(per_stream), "frames_per_stream": frames,
            "max_abs_prob_err": worst, "least_stream_argmax_agreement":
            float(per_stream.min()), "argmax_agreement": float(per_stream.mean())}


def require_step_bounds(label, stats):
    """PROB_ATOL at every step; ARGMAX_AGREEMENT_MIN for every stream over
    the run's frames (a step of one stream holds about 35 frames, where one
    near tie moves its share by 3%)."""
    log(f"  {label}: {stats['steps']} steps, max|dprob|={stats['max_abs_prob_err']:.3e} "
        f"(<= {PROB_ATOL} at every step), frame argmax agreement of the least of "
        f"{stats['streams']} streams {stats['least_stream_argmax_agreement']:.5f} over "
        f"{stats['frames_per_stream']} frames (>= {ARGMAX_AGREEMENT_MIN}; mean "
        f"{stats['argmax_agreement']:.5f})")
    if not (stats["max_abs_prob_err"] <= PROB_ATOL
            and stats["least_stream_argmax_agreement"] >= ARGMAX_AGREEMENT_MIN):
        raise AssertionError(f"{label}: outside the stated bounds")
    return stats


def phase_surface(card):
    from danspeech_tpu_torch import MultiStreamTranscriber, Recognizer, pretrained_models
    from danspeech_tpu_torch.audio.dsp import ulaw_decode_table, ulaw_encode
    from danspeech_tpu_torch.decode.beam_auto import AutoBeamDecoder
    from danspeech_tpu_torch.decode.device_lm import pack_device_lm
    from danspeech_tpu_torch.decode.lm import load_arpa
    from danspeech_tpu_torch.engine import DanSpeechRecognizer, ulaw_decode
    from danspeech_tpu_torch.models import DeepSpeechConfig, DeepSpeechModel
    from danspeech_tpu_torch.ops import gru_cuda, persist_plan, walks

    out = {}
    config = DeepSpeechConfig(**FLAGSHIP)
    model = DeepSpeechModel.init_random(config, seed=0)
    waves = seeded_waveforms(np.random.default_rng(0), 128)  # phase 4's first batch
    audio_s = sum(len(w) for w in waves) / RATE
    b3 = gru_cuda.gru_bidi_fused
    b3_launches = b1_launches = 0

    with tempfile.TemporaryDirectory() as tmp:
        # 9a: the flagship as a zip .pth package, loaded through the zoo
        path = os.path.join(tmp, "DanSpeechPrimary.pth")
        t0 = time.perf_counter()
        torch.save(reference_package(config, model.params), path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = pretrained_models.CustomModel(path)
        load_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        require_equal_params(".pth flagship", loaded, model)
        log(f"  .pth package of the flagship ({model.get_param_size()} params, zip "
            f"format): {size / 1e6:.1f} MB, written in {save_s:.2f} s, loaded by "
            f"pretrained_models.CustomModel in {load_s:.2f} s; parameters equal")
        # a small package in the legacy format
        small_cfg = DeepSpeechConfig(model_name="small-legacy", rnn_hidden_size=64,
                                     rnn_layers=2, conv_layers=2)
        small = DeepSpeechModel.init_random(small_cfg, seed=1)
        legacy = os.path.join(tmp, "small_legacy.pth")
        torch.save(reference_package(small_cfg, small.params), legacy,
                   _use_new_zipfile_serialization=False)
        t0 = time.perf_counter()
        small_loaded = DeepSpeechModel.load_model(legacy)
        legacy_s = time.perf_counter() - t0
        require_equal_params(".pth legacy", small_loaded, small)
        small_text = Recognizer(model=small_loaded).recognize(waves[0])
        if small_text != Recognizer(model=small).recognize(waves[0]):
            raise AssertionError("the legacy package transcribes otherwise than its model")
        log(f"  legacy-format package ({small_cfg.rnn_layers}x{small_cfg.rnn_hidden_size}):"
            f" {os.path.getsize(legacy) / 1e6:.2f} MB, loaded in {legacy_s:.3f} s; "
            "parameters and transcript equal")

    rec_mem, rec_pth = Recognizer(model=model), Recognizer(model=loaded)
    texts_mem, _ = timed_batch(rec_mem, waves)
    b3.launches = 0
    zero_designs()
    texts_pth, wall_pth = timed_batch(rec_pth, waves)
    groups = len(rec_pth.danspeech_recognizer._plan_groups(waves))
    pth_launches = b3.launches
    if pth_launches != config.rnn_layers * groups:
        raise AssertionError(f".pth serving: {pth_launches} gru_bidi_fused launches, "
                             f"expected {config.rnn_layers * groups}")
    require_persistent(b3, ".pth serving")
    b3_launches += pth_launches
    if texts_pth != texts_mem:
        raise AssertionError(".pth transcripts differ from the in-memory model's")
    p_pth, n_pth, rows, _ = group_forward(rec_pth.danspeech_recognizer, waves)
    p_mem, n_mem, _, _ = group_forward(rec_mem.danspeech_recognizer, waves)
    if not (torch.equal(p_pth, p_mem) and torch.equal(n_pth, n_mem)):
        raise AssertionError(".pth probabilities differ from the in-memory model's")
    log(f"  .pth served: recognize_batch of {len(waves)} waveforms ({audio_s:.2f} audio-s) in "
        f"{wall_pth:.3f} s = {audio_s / wall_pth:.1f} audio-s/s, {pth_launches} "
        f"gru_bidi_fused launches; transcripts equal and probabilities ({rows} rows) "
        f"bit-equal to the in-memory model's [{card}]")
    out["pth"] = {"bytes": size, "save_s": save_s, "load_s": load_s,
                  "legacy_load_s": legacy_s, "audio_s": audio_s, "wall_s": wall_pth,
                  "audio_s_per_s": audio_s / wall_pth, "launches": pth_launches}
    del p_pth, p_mem

    # 9b: mu-law staging
    codes = torch.arange(256, dtype=torch.int32, device="cuda").to(torch.uint8)
    dec = ulaw_decode(codes)
    if not dec.is_cuda or not np.array_equal(dec.cpu().numpy(),
                                             ulaw_decode_table().astype(np.float32)):
        raise AssertionError("the engine's mu-law decode on the card differs from the table")
    log("  ulaw_decode of all 256 codes on the card equals ulaw_decode_table")
    rec_ulaw = Recognizer(model=loaded, transfer_format="ulaw")
    rounded = [ulaw_decode_table()[ulaw_encode(w)] for w in waves]
    walls = {"auto": [], "ulaw": []}
    b3.launches = 0
    zero_designs()
    for fmt in ("auto", "ulaw", "ulaw", "auto"):
        texts, wall = timed_batch(rec_pth if fmt == "auto" else rec_ulaw, waves)
        walls[fmt].append(wall)
        if fmt == "ulaw":
            texts_ulaw = texts
    ulaw_launches = b3.launches
    require_persistent(b3, "mu-law serving")
    b3_launches += ulaw_launches
    texts_round = rec_pth.recognize_batch(rounded)
    if texts_ulaw != texts_round:
        raise AssertionError("mu-law transcripts differ from the exact path fed "
                             "round-tripped audio")
    p_u, n_u, rows, staged_u = group_forward(rec_ulaw.danspeech_recognizer, waves)
    p_a, _, _, staged_a = group_forward(rec_pth.danspeech_recognizer, rounded)
    if staged_u.dtype != torch.uint8 or staged_a.dtype != torch.int16:
        raise AssertionError(f"staged {staged_u.dtype} / {staged_a.dtype}")
    check_ulaw = compare_probs("mu-law vs int16 of the round-tripped audio", p_u, p_a,
                               n_u, rows)
    rates = {f: [audio_s / w for w in ws] for f, ws in walls.items()}
    log(f"  recognize_batch of {len(waves)} waveforms: int16 staging "
        + ", ".join(f"{r:.1f}" for r in rates["auto"]) + " audio-s/s, mu-law "
        + ", ".join(f"{r:.1f}" for r in rates["ulaw"]) + f" audio-s/s; staged "
        f"{staged_a.numel() * 2 / 1e6:.1f} MB int16 against {staged_u.numel() / 1e6:.1f} "
        f"MB mu-law; transcripts equal [{card}]")
    out["ulaw"] = {"audio_s_per_s": rates, "staged_bytes": {
        "int16": staged_a.numel() * 2, "ulaw": staged_u.numel()},
        "vs_round_tripped": check_ulaw, "launches": ulaw_launches}
    del p_u, p_a, rec_ulaw
    torch.cuda.empty_cache()

    # 9c: multi-stream serving on GPUStreamingRNN
    sconfig = DeepSpeechConfig(**GPU_STREAMING)
    params = DeepSpeechModel.init_random(sconfig, seed=2).params
    smodel = DeepSpeechModel(sconfig, {**params, "fc": params["fc"]._replace(
        weight=params["fc"].weight * COHORT_HEAD_GAIN)})
    scan = gru_cuda.gru_scan
    sms_smem = walks.device_info(torch.device("cuda", torch.cuda.current_device()))
    all_streams = cohort_chunks(max(COHORTS))
    chunk_s = COHORT_CHUNK / RATE
    cohorts = []
    for n_streams in COHORTS:
        streams = all_streams[:n_streams]
        plain = MultiStreamTranscriber(smodel, n_streams, rnn_impl="plain")
        ref_probs = []
        record_probs(plain.greedy_decoder, ref_probs)
        run_cohort(plain, streams)
        del plain
        ms = MultiStreamTranscriber(smodel, n_streams)
        got_probs, parse_ms = [], []
        record_probs(ms.greedy_decoder, got_probs)
        scan.launches = 0
        zero_designs()
        finals, step_ms = run_cohort(ms, streams, timed=True, parse_ms=parse_ms)
        launches = scan.launches
        b1_launches += launches
        expect_launches = sconfig.rnn_layers * len(streams[0])
        require_persistent(scan, f"cohort S={n_streams}")
        # every launch took the persistent design, and the plan of this
        # shape (the wrapper's own choice) is the product and row blocks wanted
        planned = persist_plan.plan_gru_scan(sconfig.rnn_hidden_size, n_streams, *sms_smem)
        product = "dot" if n_streams <= persist_plan.DOT_ROWS else "wgmma"
        blocks = 1 if n_streams <= persist_plan.GROUP_ROWS else 2
        want = f"{product}/{blocks}x64"
        if ((planned.product, planned.row_blocks, planned.rows_per_block)
                != (product, blocks, 64) or launches != expect_launches
                or scan.design_counts["persistent"] != expect_launches):
            raise AssertionError(f"cohort S={n_streams}: plan {planned}, {launches} "
                                 f"launches; expected {want}, {expect_launches}")
        if len(finals) != n_streams or not all(isinstance(f, str) for f in finals):
            raise AssertionError(f"cohort S={n_streams}: finals {finals!r}")
        check = require_step_bounds(f"cohort S={n_streams}: kernel vs plain GRU",
                                    step_stats("cohort", got_probs, ref_probs))
        check["mean_top_prob"] = float(np.mean([p.max(-1).mean() for p in got_probs]))
        steady = sorted(step_ms[1:1 + COHORT_STEADY])
        median = steady[len(steady) // 2]
        parse_step = sum(parse_ms[n_streams:n_streams * (1 + COHORT_STEADY)]) / COHORT_STEADY
        kept = n_streams * chunk_s / (median / 1e3)
        log(f"  cohort S={n_streams}: B1 plan {want} (units {planned.units}, "
            f"{planned.stages} stages), {launches} gru_scan launches; steady step "
            f"median {median:.2f} ms (min {steady[0]:.2f}, max {steady[-1]:.2f}), "
            f"host parse {parse_step:.2f} ms of it; {kept:.1f} streams kept in real "
            f"time [{card}]")
        entry = {"streams": n_streams, "plan": want, "launches": launches,
                 "step_ms": step_ms, "steady_median_ms": median,
                 "parse_ms_per_step": parse_step, "streams_in_real_time": kept,
                 "vs_plain": check}
        if n_streams == 9:
            # each stream alone through the single-stream engine
            eng = DanSpeechRecognizer(model_name=smodel)
            alone = []  # per stream, its steps' (1, T, C) probabilities
            for k in range(n_streams):
                eng.enable_streaming()
                alone.append([])
                record_probs(eng.greedy_decoder, alone[-1])
                for i, chunk in enumerate(streams[k]):
                    eng.streaming_transcribe(chunk, is_last=i == len(streams[k]) - 1,
                                             is_first=i == 0)
            entry["vs_single_streams"] = require_step_bounds(
                f"cohort S={n_streams}, each stream vs the stream alone (B=1)",
                step_stats("streams alone", got_probs,
                           [np.concatenate(step) for step in zip(*alone)]))
            del eng
        if n_streams == max(COHORTS):
            ms.step([st[0] for st in streams], is_last=False, is_first=True)
            entry["profile"] = profile_call(
                f"3 steady cohort steps at S={n_streams}",
                lambda: [ms.step([st[i] for st in streams], is_last=False, is_first=False)
                         for i in (1, 2, 3)], groups=STREAM_PROFILE_GROUPS)
            ms.reset()
        cohorts.append(entry)
        del ms
        torch.cuda.empty_cache()

    # the LM final re-decode on a cohort of 8 (the auto router: the host beam)
    labels = sconfig.labels
    with tempfile.TemporaryDirectory() as tmp:
        arpa = os.path.join(tmp, "synthetic_3gram.arpa")
        synthetic_lm_arpa(arpa, labels, seed=9)
        lm = load_arpa(arpa)
    decoder = AutoBeamDecoder(labels=labels, lm=lm,
                              device_lm=pack_device_lm(lm, labels, device="cuda"),
                              alpha=LM_ALPHA, beta=LM_BETA, beam_width=LM_BEAM,
                              blank_index=labels.index("_"), device="cuda")
    seen = []
    decode = decoder.decode

    def recorded(probs, sizes=None, **k):
        seen.append((np.array(probs, copy=True), np.array(sizes, copy=True)))
        return decode(probs, sizes, **k)

    decoder.decode = recorded
    streams = all_streams[:8]
    ms = MultiStreamTranscriber(smodel, 8, final_decoder=decoder)
    greedy = []  # each stream's greedy transcript when the final is made
    finalize = ms._finalize

    def kept_finalize():
        greedy.extend(ms.transcripts)
        return finalize()

    ms._finalize = kept_finalize
    scan.launches = 0
    t0 = time.perf_counter()
    finals, step_ms = run_cohort(ms, streams, timed=True)
    lm_wall = time.perf_counter() - t0
    b1_launches += scan.launches
    if len(seen) != 1:
        raise AssertionError("the cohort's final did not re-decode with the LM")
    cat, sizes = seen[0]
    alone = [decode(cat[k:k + 1], sizes[k:k + 1])[0][0][0] for k in range(8)]
    # past the <= 1-character gate the final is the LM's decode of the
    # stream's slice; before it, empty
    expect = [a if len(g) > 1 else "" for g, a in zip(greedy, alone)]
    compared = sum(len(g) > 1 for g in greedy)
    if len(greedy) != 8 or finals != expect or 2 * compared < len(finals):
        raise AssertionError(f"cohort LM finals {finals!r} against {expect!r} (greedy "
                             f"{greedy!r}, {compared} past the gate)")
    log(f"  cohort S=8 with the synthetic 3-gram as final_decoder "
        f"({type(decoder.for_batch(8)).__name__}): the final step {step_ms[-1]:.1f} ms "
        f"({cat.shape[1]} frames a stream), the epoch {lm_wall:.2f} s; {compared} of 8 "
        f"streams past the 1-character gate, their finals equal the decoder on the "
        f"stream's slice, the rest empty [{card}]")
    out["cohorts"] = cohorts
    out["cohort_lm"] = {"final_step_ms": step_ms[-1], "frames": int(cat.shape[1]),
                        "finals_compared": compared, "finals_equal": True}
    del ms, smodel
    torch.cuda.empty_cache()

    # 9d: silence-segmented streaming over a WAV read at a microphone's pace
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "seeded.wav")
        n_samples = seeded_wav(path, np.random.default_rng(7))
        rec = rec_mem
        items = []
        listen = rec.listen_in_background

        def recording(source):
            stopper, get = listen(source)

            def get_data():
                item = get()
                items.append(item)
                return item

            return stopper, get_data

        rec.listen_in_background = recording
        b3.launches = 0
        rec.enable_streaming()
        watchdog = threading.Timer(60.0, lambda: setattr(rec, "stream", False))
        watchdog.daemon = True
        watchdog.start()
        t0 = time.perf_counter()
        text = next(rec.streaming(paced_speech_file(path)))
        wall = time.perf_counter() - t0
        watchdog.cancel()
        rec.disable_streaming()
        rec.stream_thread_stopper(wait_for_stop=True)
        listen_launches = b3.launches
    end = next(i for i, (last, _) in enumerate(items) if last)
    phrase = np.concatenate([a for _, a in items[:end + 1]])
    if not text or text != rec.recognize(phrase):
        raise AssertionError(f"streaming gave {text!r}, recognize of the phrase differs")
    if listen_launches != config.rnn_layers:
        raise AssertionError(f"streaming: {listen_launches} gru_bidi_fused launches, "
                             f"expected {config.rnn_layers}")
    b3_launches += listen_launches
    log(f"  Recognizer.streaming over {n_samples / RATE:.1f} s of WAV at a microphone's "
        f"pace: the phrase ({len(phrase) / RATE:.2f} s) after {wall:.2f} s, its "
        f"transcript equal to recognize of the same samples; {listen_launches} "
        "gru_bidi_fused launches")
    out["listen"] = {"phrase_s": len(phrase) / RATE, "wall_s": wall,
                     "launches": listen_launches}
    out["launches"] = {"gru_bidi_fused": b3_launches, "gru_scan": b1_launches}
    return out


# ---------------------------------------------------------------------------
# Phase 10: parallelism (danspeech_tpu_torch/parallel, decode/dist_beam.py)
# ---------------------------------------------------------------------------

LONG_FORM_S = 60.0  # the long-form utterance: T' = 3000 frames
TP_ROWS = 4  # the TP check's batch, 2-4 s a row
PAR_RANKS = 2  # gloo ranks that share the card
PAR_DEADLINE_S = 420.0
PIPE_STAGES, PIPE_MICRO = 3, 32
TRAIN_LOSS_REL = 1e-3


def sharpened(model):
    """``model`` with its fc weight scaled by COHORT_HEAD_GAIN (the other
    tensors shared), so a wrong state moves the probabilities by tenths."""
    from danspeech_tpu_torch.models import DeepSpeechModel

    params = dict(model.params)
    params["fc"] = params["fc"]._replace(weight=params["fc"].weight * COHORT_HEAD_GAIN)
    return DeepSpeechModel(model.config, params)


PAR_FAILURES: list = []


def fail(msg: str) -> None:
    """Record a failed check of phase 10 and go on with the next one; the
    phase raises at its end when any failed."""
    log(f"  FAILED: {msg}")
    PAR_FAILURES.append(msg)


def compare_rows(label, probs, ref, lens):
    """Each row over its valid frames: max|dprob| <= PROB_ATOL and frame
    argmax agreement >= ARGMAX_AGREEMENT_MIN, row by row, never pooled."""
    probs, ref = torch.as_tensor(probs).float().cpu(), torch.as_tensor(ref).float().cpu()
    lens = [int(n) for n in torch.as_tensor(lens).cpu().tolist()]
    worst, least, frames, top = 0.0, 1.0, 0, []
    for r, n in enumerate(lens):
        p, q = probs[r, :n], ref[r, :n]
        if not torch.isfinite(p).all():
            fail(f"{label}: row {r}: non-finite probabilities")
        diff = float((p - q).abs().max())
        agree = float((p.argmax(-1) == q.argmax(-1)).float().mean())
        worst, least, frames = max(worst, diff), min(least, agree), frames + n
        top.append(float(q.max(-1).values.mean()))
        if diff > PROB_ATOL or agree < ARGMAX_AGREEMENT_MIN:
            fail(f"{label}: row {r} ({n} frames): max|dprob| {diff:.3e}, argmax "
                 f"agreement {agree:.5f}")
    log(f"  {label}: {len(lens)} rows, {frames} frames, each row: max|dprob| <= "
        f"{worst:.3e} (<= {PROB_ATOL}), argmax agreement >= {least:.5f} (>= "
        f"{ARGMAX_AGREEMENT_MIN}); mean top probability {np.mean(top):.4f}")
    return {"rows": len(lens), "frames": frames, "max_abs_prob_err": worst,
            "least_row_argmax_agreement": least}


def long_wave(seed=30):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(size=int(LONG_FORM_S * RATE)) * 3000, -32768,
                   32767).astype(np.int16)


def tp_waves(seed=31):
    return seeded_waveforms(np.random.default_rng(seed), TP_ROWS, 2.0, 4.0)


def padded_spect(model, waves, device):
    """(spect (B, 1, F, T), frame lengths) of int16 waveforms padded to one
    16000-sample bucket, on ``device``."""
    from danspeech_tpu_torch.features.spectrogram import SpectrogramAudioParser
    from danspeech_tpu_torch.ops import stft as stft_ops

    parser = SpectrogramAudioParser(model.audio_conf)
    maxlen = -(-max(len(w) for w in waves) // 16000) * 16000
    batch = np.zeros((len(waves), maxlen), np.float32)
    for r, w in enumerate(waves):
        batch[r, : len(w)] = w
    spect, frames = stft_ops.batched_log_spectrogram(
        torch.from_numpy(batch).to(device), torch.tensor([len(w) for w in waves]).to(device),
        parser.n_fft, parser.hop_length, parser.window.to(device), normalize=parser.normalize)
    return spect[:, None], frames


def par_lm(path):
    from danspeech_tpu_torch.decode.device_lm import pack_device_lm
    from danspeech_tpu_torch.decode.lm import load_arpa

    labels = _labels()
    lm = load_arpa(path)
    return lm, pack_device_lm(lm, labels, device="cuda")


def _labels():
    from danspeech_tpu_torch.models import DeepSpeechConfig

    return DeepSpeechConfig(**FLAGSHIP).labels


def sharded_tops(probs, lengths, dlm, mesh):
    """The beam-sharded search's best transcript per row (the published
    settings), and its wall time."""
    from danspeech_tpu_torch.decode.dist_beam import ctc_beam_search_beam_sharded

    labels = _labels()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lab, _, lens, _ = ctc_beam_search_beam_sharded(
        probs, lengths, mesh, beam_width=LM_BEAM, blank=labels.index("_"), lm=dlm,
        alpha=LM_ALPHA, beta=LM_BETA, space=labels.index(" "), top=1)
    lab, lens = lab.cpu().numpy(), lens.cpu().numpy()
    wall = time.perf_counter() - t0
    return ["".join(labels[i] for i in lab[b, 0, : lens[b, 0]]) for b in range(len(lab))], wall


def gloo_cuda_probe(mesh):
    """Which gloo collectives take CUDA tensors on this torch (the mesh's
    helpers stage every exchange of a gloo group on CUDA through host
    memory): a collective that refuses them raises on every rank before it
    communicates. Point to point is not probed: torch 2.11's gloo takes a
    CUDA tensor in ``send`` and its TCP transport then aborts the process
    (``writev ... Bad address``)."""
    import torch.distributed as dist

    x = torch.ones(4, device=mesh.device)
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(
            mesh.world_size)], x),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
    }
    took = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
            took[name] = True
        except RuntimeError as e:
            took[name] = str(e).splitlines()[0][:120]
    return took


def _par_rank(rank, n, store, workdir):
    """One of the gloo ranks on cuda:0: the long form of both models, TP
    direction and hidden mode on the flagship, the sharded beam, and one
    data-parallel train step; results pickled to ``workdir``."""
    import pickle
    from datetime import timedelta

    import torch.distributed as dist

    out = {}
    try:
        torch.set_num_threads(max(1, (os.cpu_count() or n) // n))
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=n, timeout=timedelta(seconds=300))
        out = _par_rank_work(rank, workdir)
    except BaseException:
        import traceback

        out["error"] = traceback.format_exc()
    finally:
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        if dist.is_initialized():
            dist.destroy_process_group()


def _par_rank_work(rank, workdir):
    import pickle

    from danspeech_tpu_torch import Recognizer
    from danspeech_tpu_torch.models import DeepSpeechConfig, DeepSpeechModel
    from danspeech_tpu_torch.parallel import make_mesh, pack_tp_params, tp_forward
    from danspeech_tpu_torch.parallel.batch import device_params
    from danspeech_tpu_torch.parallel.time_shard import long_form_probs
    from danspeech_tpu_torch.train import data as tdata
    from danspeech_tpu_torch.train import step as tstep

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    try:
        make_mesh(device="cuda:0")  # NCCL is the default on CUDA: the gloo group refuses
    except ValueError:
        pass
    else:
        raise AssertionError("make_mesh on cuda:0 took the gloo group without backend=")
    mesh = make_mesh(device="cuda:0", backend="gloo")
    out = {"mesh": repr(mesh), "transport": mesh.transport,
           "gloo_cuda": gloo_cuda_probe(mesh)}

    base = DeepSpeechModel.init_random(DeepSpeechConfig(**FLAGSHIP), seed=0)
    flag = sharpened(base)
    for key, cfg, seed in (("flagship", FLAGSHIP, 0), ("uni", GPU_STREAMING, 2)):
        model = flag if key == "flagship" else sharpened(
            DeepSpeechModel.init_random(DeepSpeechConfig(**cfg), seed=seed))
        rec = Recognizer(model=model, device="cuda:0")
        rec.recognize_long_form(inp["long"][: 4 * RATE], mesh=mesh)  # warm-up
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text = rec.recognize_long_form(inp["long"], mesh=mesh)
        wall = time.perf_counter() - t0
        launches = read_launches()
        probs, lens = long_form_probs(model, inp["long"], mesh,
                                      params=rec.danspeech_recognizer._compute_params)
        out[key] = {"text": text, "wall_s": wall, "launches": launches,
                    "probs": probs.cpu().numpy(), "lens": lens.cpu().numpy()}
        del rec, model, probs
        torch.cuda.empty_cache()

    n = mesh.world_size
    tp_mesh = make_mesh(n_data=1, n_model=n, device="cuda:0", backend="gloo")
    spect, frames = padded_spect(flag, inp["tp_waves"], mesh.device)
    for mode in ("direction", "hidden"):
        src = pack_tp_params(flag.params, n) if mode == "hidden" else flag.params
        params = device_params(src, mesh.device)
        tp_forward(params, flag.config, spect, frames, tp_mesh, mode=mode)  # warm-up
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs, lens = tp_forward(params, flag.config, spect, frames, tp_mesh, mode=mode)
        torch.cuda.synchronize()
        out[f"tp_{mode}"] = {"probs": probs.cpu().numpy(), "lens": lens.cpu().numpy(),
                             "wall_s": time.perf_counter() - t0, "launches": read_launches()}
        del params
    del flag
    torch.cuda.empty_cache()

    _, dlm = par_lm(inp["arpa"])
    probs = torch.from_numpy(inp["beam_probs"]).cuda()
    sharded_tops(probs[:1], inp["beam_lengths"][:1], dlm, mesh)  # warm-up
    tops, wall = sharded_tops(probs, inp["beam_lengths"], dlm, mesh)
    out["beam"] = {"tops": tops, "wall_s": wall}
    del dlm, probs

    config, params = base.config, base.params
    spec = tstep.make_optimizer(TRAIN_LR)
    state = tstep.train_state_from_params(params, spec, mesh=mesh)
    step = tstep.make_wave_train_step(config, spec, augment=False, mesh=mesh)
    local = tdata.shard_batch(tdata.Batch(*inp["train_batch"]), mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = step(state, *local)
    loss = float(loss)
    wall = time.perf_counter() - t0
    grads = grad_groups(state.params)
    out["train"] = {"loss": loss, "wall_s": wall, "rows": len(local.waves),
                    "checksum": {k: float(g.double().square().sum()) for k, g in grads.items()}}
    del state, step
    torch.cuda.empty_cache()
    if rank == 0:
        # one rank on all rows, the reference of the data-parallel step
        ref_state = tstep.train_state_from_params(params, spec, device="cuda:0")
        ref_step = tstep.make_wave_train_step(config, spec, augment=False)
        ref_state, ref_loss = ref_step(ref_state, *inp["train_batch"])
        ref = grad_groups(ref_state.params)
        out["train"]["ref_loss"] = float(ref_loss)
        out["train"]["grad_rel"] = {k: float((grads[k] - ref[k]).norm() / ref[k].norm())
                                    for k in ref}
    return out


def run_par_ranks(workdir):
    """PAR_RANKS spawned processes on cuda:0, joined with a deadline."""
    import multiprocessing
    import pickle

    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(workdir, "store")
    procs = [ctx.Process(target=_par_rank, args=(r, PAR_RANKS, store, workdir))
             for r in range(PAR_RANKS)]
    for p in procs:
        p.start()
    end = time.perf_counter() + PAR_DEADLINE_S
    for p in procs:
        p.join(max(0.0, end - time.perf_counter()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(30)
    if hung:
        raise AssertionError(f"ranks {hung} ran past {PAR_DEADLINE_S} s and were killed")
    results = []
    for r, p in enumerate(procs):
        path = os.path.join(workdir, f"rank{r}.pkl")
        if not os.path.exists(path):
            raise AssertionError(f"rank {r} died with exit code {p.exitcode} "
                                 "before it wrote its results")
        with open(path, "rb") as f:
            res = pickle.load(f)
        if "error" in res:
            raise AssertionError(f"rank {r} failed:\n{res['error']}")
        results.append(res)
    return results


def phase_parallel(card):
    import pickle

    from danspeech_tpu_torch import Recognizer
    from danspeech_tpu_torch.decode.greedy import GreedyDecoder, collapse_batch
    from danspeech_tpu_torch.models import DeepSpeechConfig, DeepSpeechModel
    from danspeech_tpu_torch.models import deepspeech as ds
    from danspeech_tpu_torch.parallel import PipelinedTranscriber, ShardedTranscriber, make_mesh
    from danspeech_tpu_torch.parallel.time_shard import long_form_probs, pad_time_for_mesh

    out = {}
    launches = {"gru_bidi_fused": 0, "gru_scan": 0, "gru_scan_bidi": 0}
    mesh = make_mesh()  # no launcher: this process alone, NCCL on cuda:0
    log(f"  {mesh}")
    if (mesh.backend, mesh.world_size, mesh.device.type) != ("nccl", 1, "cuda"):
        fail(f"make_mesh() gave {mesh}")
    fconfig = DeepSpeechConfig(**FLAGSHIP)
    flag = sharpened(DeepSpeechModel.init_random(fconfig, seed=0))
    waves = seeded_waveforms(np.random.default_rng(0), 128)  # phase 4's first batch
    audio_s = sum(len(w) for w in waves) / RATE

    # 10a: the data-parallel transcriber at world size 1 against recognize_batch
    rec = Recognizer(model=flag)
    eng = rec.danspeech_recognizer
    default_texts, default_wall = timed_batch(rec, waves)
    default_texts, default_wall = timed_batch(rec, waves)
    # the rows staged as one dispatch group in their own order, the
    # transcriber's shape, and decoded as the engine decodes a group
    maxlen = -(-max(len(w) for w in waves) // eng.SAMPLE_BUCKET) * eng.SAMPLE_BUCKET
    staged, lengths = eng._stage_group(waves, list(range(len(waves))), maxlen)
    group_probs, group_lens = eng._forward(eng._compute_params, staged.to("cuda"),
                                           torch.from_numpy(lengths).to("cuda"))
    one_texts = collapse_batch(group_probs.argmax(-1).cpu().numpy(),
                               group_lens.cpu().numpy(), eng.labels, eng.labels.index("_"))
    del staged
    tr = ShardedTranscriber(flag, mesh)
    dec = GreedyDecoder(flag.labels, blank_index=flag.labels.index("_"))
    tr.transcribe(waves[:8], dec)  # warm-up
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts = tr.transcribe(waves, dec)
    dp_wall = time.perf_counter() - t0
    dp_launches = read_launches()
    if dp_launches["gru_bidi_fused"] != fconfig.rnn_layers:
        fail(f"ShardedTranscriber: launches {dp_launches}")
    launches["gru_bidi_fused"] += dp_launches["gru_bidi_fused"]
    bad = [i for i, (a, b) in enumerate(zip(texts, one_texts)) if a != b]
    same_default = sum(a == b for a, b in zip(texts, default_texts))
    probs, lens = tr.acoustic_probs(waves)
    maxlen = -(-max(len(w) for w in waves) // 16000) * 16000
    staged = np.zeros((len(waves), maxlen), np.float32)
    for r, w in enumerate(waves):
        staged[r, : len(w)] = w
    ref, _ = eng._forward(eng._compute_params, torch.from_numpy(staged).cuda(),
                          torch.tensor([len(w) for w in waves]).cuda(), rnn_impl="plain")
    check_dp = compare_rows("ShardedTranscriber (world 1) vs the plain GRU", probs, ref, lens)
    same = float((torch.from_numpy(probs).cuda() - group_probs).abs().max())
    log(f"  ShardedTranscriber vs the engine's dispatch group, same rows in the same "
        f"places: max|dprob| {same:.3e}; transcripts differ on rows {bad[:8]}")
    if bad:
        fail(f"ShardedTranscriber and recognize_batch (one group) differ on rows {bad[:8]}")
    del ref, staged, group_probs
    log(f"  ShardedTranscriber over {len(waves)} waveforms ({audio_s:.2f} audio-s): "
        f"{audio_s / dp_wall:.1f} audio-s/s ({fconfig.rnn_layers} gru_bidi_fused "
        f"launches), transcripts equal recognize_batch's in one group; recognize_batch "
        f"in its own groups {audio_s / default_wall:.1f} audio-s/s, {same_default} of "
        f"{len(waves)} transcripts the same there [{card}]")
    out["dp"] = {"audio_s": audio_s, "audio_s_per_s": audio_s / dp_wall,
                 "recognize_batch_audio_s_per_s": audio_s / default_wall,
                 "rows_equal_default_groups": same_default, "vs_plain": check_dp,
                 "launches": dp_launches["gru_bidi_fused"]}

    # 10b: the pipeline, 3 stages on the card, against the transcriber
    pp = PipelinedTranscriber(flag, devices=["cuda:0"] * PIPE_STAGES, micro_batch=PIPE_MICRO)
    pp.acoustic_probs(waves[:PIPE_MICRO])  # warm-up
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pp_probs, pp_lens = pp.acoustic_probs(waves)
    pp_wall = time.perf_counter() - t0
    pp_launches = read_launches()["gru_bidi_fused"]
    expect = fconfig.rnn_layers * -(-len(waves) // PIPE_MICRO)
    if pp_launches != expect:
        fail(f"pipeline: {pp_launches} gru_bidi_fused launches, expected {expect}")
    launches["gru_bidi_fused"] += pp_launches
    if not np.array_equal(pp_lens, lens):
        fail("the pipeline's output lengths differ from the transcriber's")
    check_pp = compare_rows(f"PipelinedTranscriber ({PIPE_STAGES} stages on cuda:0, "
                            f"microbatch {PIPE_MICRO}) vs ShardedTranscriber",
                            pp_probs, probs, lens)
    log(f"  PipelinedTranscriber: {audio_s / pp_wall:.1f} audio-s/s, stages "
        f"{[len(r) for r in pp.stage_layers]} layers, {pp_launches} launches [{card}]")
    out["pipeline"] = {"stages": PIPE_STAGES, "micro_batch": PIPE_MICRO,
                       "audio_s_per_s": audio_s / pp_wall, "vs_sharded": check_pp,
                       "launches": pp_launches}
    del pp, tr, probs, pp_probs, rec, eng
    torch.cuda.empty_cache()

    # 10c: the long form at world size 1 (B2 on the flagship, B1 on the uni model)
    wave = long_wave()
    out["long_form"] = {}
    world1 = {}
    for key, cfg, seed, kernel in (("flagship", FLAGSHIP, 0, "gru_scan_bidi"),
                                   ("uni", GPU_STREAMING, 2, "gru_scan")):
        config = DeepSpeechConfig(**cfg)
        model = flag if key == "flagship" else sharpened(
            DeepSpeechModel.init_random(config, seed=seed))
        rec = Recognizer(model=model)
        params = rec.danspeech_recognizer._compute_params
        rec.recognize_long_form(wave[: 4 * RATE], mesh=mesh)  # warm-up
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text = rec.recognize_long_form(wave, mesh=mesh)
        wall = time.perf_counter() - t0
        got = read_launches()
        # B2's persistent launches are gru_scan_persist_kernel's, counted on gru_scan
        expect = {"gru_scan": config.rnn_layers}
        if {k: v for k, v in got.items() if v} != expect:
            fail(f"long form {key}: launches {got}, expected {expect}")
        launches[kernel] += got["gru_scan"]
        probs, lens = long_form_probs(model, wave, mesh, params=params)
        spect, frames = padded_spect(model, [wave], mesh.device)
        with torch.inference_mode():
            ref, _ = ds.forward(params, config, pad_time_for_mesh(spect, 1), frames,
                                rnn_impl="plain")
        check = compare_rows(f"long form {cfg['model_name']} ({LONG_FORM_S:.0f} s, "
                             "world 1) vs forward on the plain GRU", probs, ref, lens)
        log(f"  recognize_long_form {cfg['model_name']}: {LONG_FORM_S:.0f} s of audio "
            f"(T' = {int(lens[0])}) in {wall:.3f} s = {LONG_FORM_S / wall:.1f} audio-s/s, "
            f"{config.rnn_layers} {kernel} launches [{card}]")
        world1[key] = {"text": text, "probs": probs.cpu().numpy(), "lens": lens.cpu().numpy()}
        out["long_form"][key] = {"world1_wall_s": wall, "world1_audio_s_per_s":
                                 LONG_FORM_S / wall, "frames": int(lens[0]),
                                 "world1_vs_plain": check, "world1_launches": got}
        del rec, probs, ref, model
        torch.cuda.empty_cache()

    # 10d: the sharded beam at world size 1 against the device beam
    with tempfile.TemporaryDirectory() as workdir:
        arpa = os.path.join(workdir, "synthetic_3gram.arpa")
        synthetic_lm_arpa(arpa, _labels(), seed=9)
        lm, dlm = par_lm(arpa)
        rows, t_max = 8, 401
        beam_probs, _ = peaky_probs(np.random.default_rng(10), lm, _labels(), rows, t_max)
        beam_lengths = np.full(rows, t_max, np.int32)
        probs_d = torch.from_numpy(beam_probs).cuda()
        dev_tops, _ = device_tops(probs_d, beam_lengths, dlm, _labels())
        sharded_tops(probs_d[:1], beam_lengths[:1], dlm, mesh)  # warm-up
        w1_tops, w1_beam_s = sharded_tops(probs_d, beam_lengths, dlm, mesh)
        if w1_tops != dev_tops:
            fail("the sharded beam (world 1) differs from the device beam")
        log(f"  sharded beam, world 1: B={rows}, T={t_max}, beam {LM_BEAM}: top-1 equal to "
            f"the device beam on every row; {w1_beam_s * 1e3:.1f} ms [{card}]")
        del dlm, lm, probs_d

        # 10e: two gloo ranks on the card
        rng = np.random.default_rng(6)
        batch, train_audio_s = train_batch(rng, fconfig, TRAIN_BATCH)
        with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
            pickle.dump({"long": wave, "tp_waves": tp_waves(), "arpa": arpa,
                         "beam_probs": beam_probs, "beam_lengths": beam_lengths,
                         "train_batch": batch}, f)
        del flag
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = run_par_ranks(workdir)
        ranks_s = time.perf_counter() - t0
    log(f"  {PAR_RANKS} gloo ranks on cuda:0 ({ranks[0]['transport']}) ran in "
        f"{ranks_s:.1f} s; gloo collectives on CUDA tensors: {ranks[0]['gloo_cuda']}")
    out["ranks"] = {"n": PAR_RANKS, "transport": ranks[0]["transport"],
                    "gloo_cuda_tensors": ranks[0]["gloo_cuda"], "wall_s": ranks_s}
    for key, cfg in (("flagship", FLAGSHIP), ("uni", GPU_STREAMING)):
        config = DeepSpeechConfig(**cfg)
        expect = {"gru_scan": 2 * config.rnn_layers} if key == "flagship" else \
            {"gru_scan": config.rnn_layers}
        for r, res in enumerate(ranks):
            got = {k: v for k, v in res[key]["launches"].items() if v}
            if got != expect:
                fail(f"long form {key}, rank {r}: launches {got}, "
                                     f"expected {expect}")
            if res[key]["text"] != world1[key]["text"]:
                fail(f"long form {key}, rank {r}: the transcript differs "
                                     "from world size 1's")
        check = compare_rows(f"long form {cfg['model_name']}, {PAR_RANKS} ranks vs world 1",
                             ranks[0][key]["probs"], world1[key]["probs"], world1[key]["lens"])
        walls = [res[key]["wall_s"] for res in ranks]
        log(f"  recognize_long_form {cfg['model_name']} over {PAR_RANKS} ranks: "
            f"{max(walls):.3f} s = {LONG_FORM_S / max(walls):.1f} audio-s/s, per rank "
            f"{expect}, transcript equal to world 1's [{card}]")
        out["long_form"][key].update({
            "ranks_wall_s": walls, "ranks_audio_s_per_s": LONG_FORM_S / max(walls),
            "ranks_vs_world1": check, "ranks_launches": [res[key]["launches"] for res in ranks]})

    tp_flag = sharpened(DeepSpeechModel.init_random(fconfig, seed=0))
    spect, frames = padded_spect(tp_flag, tp_waves(), torch.device("cuda", 0))
    with torch.inference_mode():
        tp_ref, tp_lens = ds.forward(
            Recognizer(model=tp_flag).danspeech_recognizer._compute_params, fconfig,
            spect, frames)
    out["tp"] = {}
    for mode in ("direction", "hidden"):
        for r, res in enumerate(ranks):
            got = {k: v for k, v in res[f"tp_{mode}"]["launches"].items() if v}
            expect = {"gru_scan": fconfig.rnn_layers} if mode == "direction" else {}
            if got != expect:
                fail(f"TP {mode}, rank {r}: launches {got}, expected {expect}")
        check = compare_rows(f"TP {mode} mode ({PAR_RANKS} ranks) vs forward",
                             ranks[0][f"tp_{mode}"]["probs"], tp_ref, tp_lens)
        wall = max(res[f"tp_{mode}"]["wall_s"] for res in ranks)
        log(f"  TP {mode} mode on the flagship, {TP_ROWS} rows of 2-4 s: {wall * 1e3:.1f} ms "
            f"[{card}]")
        out["tp"][mode] = {"wall_s": wall, "vs_forward": check,
                           "launches": ranks[0][f"tp_{mode}"]["launches"]}
    del tp_flag, tp_ref
    torch.cuda.empty_cache()

    for r, res in enumerate(ranks):
        if res["beam"]["tops"] != w1_tops:
            fail(f"sharded beam, rank {r}: top-1 differs from world 1's")
    beam_s = max(res["beam"]["wall_s"] for res in ranks)
    log(f"  sharded beam over {PAR_RANKS} ranks: top-1 equal to world 1's on all {rows} rows; "
        f"{beam_s * 1e3:.1f} ms [{card}]")
    out["beam"] = {"rows": rows, "t": t_max, "beam": LM_BEAM, "world1_ms": w1_beam_s * 1e3,
                   "ranks_ms": beam_s * 1e3}

    tr0 = ranks[0]["train"]
    for r, res in enumerate(ranks[1:], 1):
        if res["train"]["checksum"] != tr0["checksum"]:
            fail(f"DP step: rank {r}'s gradients differ from rank 0's")
    loss_rel = abs(tr0["loss"] - tr0["ref_loss"]) / abs(tr0["ref_loss"])
    worst = max(tr0["grad_rel"].values())
    log(f"  DP train step of the flagship, B={TRAIN_BATCH} over {PAR_RANKS} ranks "
        f"({tr0['rows']} rows a rank): loss {tr0['loss']:.5f} against one rank's "
        f"{tr0['ref_loss']:.5f} (rel {loss_rel:.2e} <= {TRAIN_LOSS_REL}); gradients per group "
        + ", ".join(f"{k} {v:.2e}" for k, v in tr0["grad_rel"].items())
        + f" (<= {GRAD_REL_TOL}); step {max(res['train']['wall_s'] for res in ranks):.3f} s "
        f"[{card}]")
    if loss_rel > TRAIN_LOSS_REL or worst > GRAD_REL_TOL:
        fail("the data-parallel step differs from the one-rank step")
    out["train"] = {"loss": tr0["loss"], "ref_loss": tr0["ref_loss"], "loss_rel": loss_rel,
                    "grad_rel": tr0["grad_rel"], "audio_s": train_audio_s,
                    "wall_s": [res["train"]["wall_s"] for res in ranks]}
    out["launches"] = launches
    import torch.distributed as dist

    dist.destroy_process_group()  # the mesh's one-rank NCCL group
    if PAR_FAILURES:
        raise AssertionError(f"phase 10: {len(PAR_FAILURES)} checks failed: {PAR_FAILURES}")
    return out


# ---------------------------------------------------------------------------
# Phase 11: the gallery (danspeech_tpu_torch/examples), the spectrogram's two
# DFTs and the conv layouts
# ---------------------------------------------------------------------------

N_FFT, HOP = 320, 160
# rFFT against the matmul DFT, normalised log units (ROADMAP C4): its 5e-4
# holds for all but a few near-zero bins (the Nyquist bin of a frame), whose
# log1p magnifies the absolute rounding: on the CPU, 6 and 16 of phase 4's
# rows gave a largest 4.4e-3 and 2.7e-3, a share of 1.0e-5 and 3.4e-6
# beyond 5e-4. So the share beyond C4_ATOL is held to C4_SHARE, the 99.9th
# percentile to C4_P999 and the largest to C4_MAX
C4_ATOL, C4_SHARE, C4_P999, C4_MAX = 5e-4, 1e-4, 2e-5, 1e-2
# one row's magnitudes, relative to the frame's largest bin: the two float32
# DFTs met within 9.7e-7 on the CPU (tests/test_torch_stft.py)
MAG_RTOL = 1e-5
# one chunk's log spectrogram with a caller's mean and std: a near-zero bin
# magnifies the absolute rounding (tests/test_torch_stft.py LOG_MAX)
STREAM_LOG_ATOL = 2e-3
# a conv layout against F.conv2d, relative to the output's largest
# magnitude: bf16 outputs round to bf16 (C5), float32 ones may meet TF32
LAYOUT_REL = 1e-2
CONV_BATCH, CONV_T = 128, 801  # the flagship's serving batch, 8 s of input frames
# (layer, C_in, C_out, F_in, kernel, stride, padding, layouts): the flagship's
# convs (models/config.py CONV_SPECS)
CONV_LAYERS = (
    ("conv1", 1, 32, 161, (41, 11), (2, 2), (20, 5),
     ("conv2d_banded_cin1", "conv2d_s2d_cin1")),
    ("conv2", 32, 32, 81, (21, 11), (2, 1), (10, 5), ("conv2d_s2d_freq",)),
    ("conv3", 32, 96, 41, (21, 11), (2, 1), (10, 5), ("conv2d_s2d_freq",)),
)
VIDEO_S = 60.0  # the long recording of video_transcribe_simulation
GALLERY_WATCHDOG_S = 120.0  # a streaming twin waiting longer is interrupted
FLOAT32_TITLE = ("phase 12: float32 on the card (the float32 variants of B1-B9 and the GEMM: "
                 "entries, serving, streaming, long form, training; LSTM5x800 and "
                 "Tanh5x800 served and trained)")
GALLERY_TITLE = ("phase 11: the gallery (the spectrogram's two DFTs, the conv layouts, "
                 "the eight twins of examples/)")


def phase_spectra(card, waves):
    """11a: ``batched_log_spectrogram`` of ``waves`` with the rFFT and the
    matmul DFT (also with TF32 allowed in the process), ``magnitude_stft``
    and ``streaming_log_spectrogram`` on one row, and the three conv layouts
    against ``F.conv2d`` at the flagship's conv shapes, in bf16 and float32;
    each checked and timed."""
    from danspeech_tpu_torch.features.windows import get_window
    from danspeech_tpu_torch.ops import conv as conv_ops
    from danspeech_tpu_torch.ops import stft

    out = {}
    batch = torch.zeros(len(waves), max(len(w) for w in waves))
    for i, w in enumerate(waves):
        batch[i, : len(w)] = torch.from_numpy(w.astype(np.float32))
    batch = batch.cuda()
    lens = torch.tensor([len(w) for w in waves], device="cuda")
    win = torch.from_numpy(get_window("hamming", N_FFT).astype(np.float32)).cuda()

    def spect(use_fft):
        return stft.batched_log_spectrogram(batch, lens, N_FFT, HOP, win, use_fft=use_fft)

    fft, frame_lens = spect(True)
    dft, _ = spect(False)
    valid = torch.arange(fft.shape[-1], device="cuda")[None, :] < frame_lens[:, None].long()
    d = (fft - dft).abs().transpose(1, 2)[valid].flatten().sort().values
    diff, p999 = float(d[-1]), float(d[int(0.999 * (d.numel() - 1))])
    share = float((d > C4_ATOL).float().mean())
    del d
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")  # TF32 allowed for float32 products
    try:
        dft_tf32_allowed, _ = spect(False)
        # the same product with TF32 taken, on the longest row
        row = int(lens.argmax())
        frames = stft.frame_signal(batch[row, : int(lens[row])], N_FFT, HOP, True) * win
        cos_m, sin_m = stft._dft_matrices(N_FFT, torch.float32, frames.device)
        re, im = frames @ cos_m, frames @ sin_m
        mag_tf32 = torch.sqrt(re * re + im * im).T
    finally:
        torch.set_float32_matmul_precision(saved)
    guarded = torch.equal(dft_tf32_allowed, dft)
    y = batch[row, : int(lens[row])]
    mag_fft = stft.magnitude_stft(y, N_FFT, HOP, win, use_fft=True)
    mag_dft = stft.magnitude_stft(y, N_FFT, HOP, win, use_fft=False)
    scale = mag_fft.max(dim=0).values
    mag_rel = float(((mag_dft - mag_fft).abs() / scale).max())
    tf32_rel = float(((mag_tf32 - mag_fft).abs() / scale).max())
    chunk = y[: 6240 + N_FFT]
    mean, std = torch.tensor(4.0, device="cuda"), torch.tensor(2.0, device="cuda")
    s_fft = stft.streaming_log_spectrogram(chunk, N_FFT, HOP, win, mean, std, use_fft=True)
    s_dft = stft.streaming_log_spectrogram(chunk, N_FFT, HOP, win, mean, std, use_fft=False)
    stream_diff = float((s_fft - s_dft).abs().max())
    times = {
        "batched_rfft_ms": time_ms(lambda: spect(True), 10),
        "batched_matmul_dft_ms": time_ms(lambda: spect(False), 10),
        "magnitude_stft_rfft_ms": time_ms(
            lambda: stft.magnitude_stft(y, N_FFT, HOP, win, use_fft=True), 20),
        "magnitude_stft_matmul_dft_ms": time_ms(
            lambda: stft.magnitude_stft(y, N_FFT, HOP, win, use_fft=False), 20),
        "streaming_rfft_ms": time_ms(lambda: stft.streaming_log_spectrogram(
            chunk, N_FFT, HOP, win, mean, std, use_fft=True), 20),
        "streaming_matmul_dft_ms": time_ms(lambda: stft.streaming_log_spectrogram(
            chunk, N_FFT, HOP, win, mean, std, use_fft=False), 20),
    }
    log(f"  batched_log_spectrogram of {len(waves)} waveforms {tuple(fft.shape)}: rFFT "
        f"against the matmul DFT over the valid frames: {share:.2e} of the elements beyond "
        f"{C4_ATOL} (<= {C4_SHARE}), 99.9th percentile {p999:.2e} (<= {C4_P999}), largest "
        f"{diff:.3e} (<= {C4_MAX}); with TF32 allowed in "
        f"the process the DFT is {'bit-equal' if guarded else 'NOT equal'} (a TF32 product "
        f"would move a magnitude by {tf32_rel:.2e} of its frame's largest bin, the guarded "
        f"one {mag_rel:.2e}, <= {MAG_RTOL}); one {y.numel() / RATE:.2f} s row's "
        f"streaming_log_spectrogram chunk max|d| {stream_diff:.3e} (<= {STREAM_LOG_ATOL}) [{card}]")
    log("  " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    if not (share <= C4_SHARE and p999 <= C4_P999 and diff <= C4_MAX and guarded
            and mag_rel <= MAG_RTOL and stream_diff <= STREAM_LOG_ATOL):
        raise AssertionError("phase 11a: the spectrograms' two DFTs differ beyond their bounds")
    out["spectrogram"] = {"rows": len(waves), "shape": list(fft.shape), "max_abs_diff": diff,
                          "p999_abs_diff": p999, "share_beyond_c4": share,
                          "tf32_guarded": guarded, "magnitude_rel": mag_rel,
                          "tf32_magnitude_rel": tf32_rel, "streaming_max_abs_diff": stream_diff,
                          **times}
    del fft, dft, dft_tf32_allowed, batch

    # float32 both ways: TF32 allowed (PyTorch's default for cuDNN, what a
    # user's process runs) and off (what phase 3 leaves for the rest of a
    # whole run)
    settings = (("bf16", torch.bfloat16, None), ("float32, TF32", torch.float32, True),
                ("float32, no TF32", torch.float32, False))
    saved = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    gen = torch.Generator(device="cuda").manual_seed(11)
    layouts, t_in = [], CONV_T
    try:
        for layer, cin, cout, f, (kf, kt), stride, pad, names in CONV_LAYERS:
            x = torch.randn(CONV_BATCH, cin, f, t_in, generator=gen, device="cuda")
            w = (torch.randn(cout, cin, kf, kt, generator=gen, device="cuda")
                 / (cin * kf * kt) ** 0.5)
            b = torch.randn(cout, generator=gen, device="cuda")
            for label, dtype, tf32 in settings:
                if tf32 is not None:
                    torch.backends.cudnn.allow_tf32 = tf32
                    torch.set_float32_matmul_precision("high" if tf32 else "highest")
                wd = w.to(dtype)
                ref = conv_ops.conv2d(x, wd, b, stride, pad)
                cudnn_ms = time_ms(lambda: conv_ops.conv2d(x, wd, b, stride, pad), 5)
                for name in names:
                    fn = getattr(conv_ops, name)
                    got = fn(x, wd, b, stride, pad)
                    rel = float((got - ref).abs().max() / ref.abs().max())
                    ms = time_ms(lambda: fn(x, wd, b, stride, pad), 5)
                    ok = tuple(got.shape) == tuple(ref.shape) and rel <= LAYOUT_REL
                    log(f"  {layer} {tuple(x.shape)} -> {tuple(ref.shape)} {label}: {name} "
                        f"{ms:.3f} ms, cuDNN conv2d {cudnn_ms:.3f} ms; max|d| {rel:.2e} of the "
                        f"largest output (<= {LAYOUT_REL}) [{card}]")
                    layouts.append({"layer": layer, "dtype": label, "layout": name,
                                    "input": list(x.shape), "output": list(ref.shape),
                                    "ms": ms, "library_ms": cudnn_ms, "max_rel_err": rel})
                    if not ok:
                        raise AssertionError(f"phase 11a: {name} differs from F.conv2d at {layer}")
                    del got
                del ref
            t_in = (t_in + 2 * pad[1] - kt) // stride[1] + 1
            del x
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    torch.cuda.empty_cache()
    out["conv_layouts"] = layouts
    return out


# the lookahead at GPUStreamingRNN's batch shape (T, B, H, C): one dispatch
# group of 128 rows of 8 s, context 20
LOOKAHEAD_SHAPE = (401, 128, 2000, 20)
# the stencil against its plain version, relative to the largest output:
# float32 sums of the same 20 products in another order (20 * 2^-24 = 1.2e-6)
LOOKAHEAD_RTOL = 1e-5
LOOKAHEAD_TITLE = "phase 11c: the lookahead stencil alone (csrc/lookahead.cu)"


def phase_lookahead(card):
    """11c: the lookahead stencil (``csrc/lookahead.cu``) alone at
    GPUStreamingRNN's batch shape, float32 with TF32 off: the forward and
    the past-tap walk (dx) against the stacked plain version, each timed
    beside the plain version, one ``F.conv1d(groups=H)`` on the
    (B, H, T + C - 1) layout (the library's depthwise convolution, which the
    port never calls), the gradient's tap pass (dw) and the byte bound; then
    ragged shapes on the scalar path (H = 667, and x one float off 16-byte
    alignment)."""
    import torch.nn.functional as F

    from danspeech_tpu_torch.ops import lookahead_cuda as la

    t, b, h, c = LOOKAHEAD_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(t, b, h, generator=gen, device="cuda")
    w = torch.randn(h, c, generator=gen, device="cuda")
    g = torch.randn(t, b, h, generator=gen, device="cuda")
    saved = f32_flags()
    set_f32_flags(F32_FLAGS)
    n0 = la.lookahead.launches
    try:
        def rel(got, ref):
            return float((got - ref).abs().max() / ref.abs().max())

        ref = la.lookahead_plain(x, w)
        fwd_rel = rel(la.stencil(x, w), ref)
        past_rel = rel(la.stencil(g, w, reverse=True), la.lookahead_past_plain(g, w))
        x_ncl = F.pad(x.permute(1, 2, 0), (0, c - 1)).contiguous()  # (B, H, T + C - 1)
        w_conv = w[:, None, :].contiguous()
        lib_rel = rel(F.conv1d(x_ncl, w_conv, groups=h).permute(2, 0, 1), ref)
        del ref
        times = {
            "ms": time_ms(lambda: la.stencil(x, w), 20),
            "dx_ms": time_ms(lambda: la.stencil(g, w, reverse=True), 20),
            "library_ms": time_ms(lambda: F.conv1d(x_ncl, w_conv, groups=h), 20),
            "dw_ms": time_ms(lambda: la.tap_grads(x, g, c), 3),
            "plain_ms": time_ms(lambda: la.lookahead_plain(x, w), 3),
        }
        del x_ncl
        ragged = []
        for rt, rb, rh, offset in ((57, 3, 667, 0), (401, 128, 2000, 1), (21, 5, 64, 0)):
            flat = torch.randn(rt * rb * rh + offset, generator=gen, device="cuda")
            rx = flat[offset:].view(rt, rb, rh)
            rw = torch.randn(rh, c, generator=gen, device="cuda")
            e = rel(la.stencil(rx, rw), la.lookahead_plain(rx, rw))
            ragged.append({"T": rt, "B": rb, "H": rh, "x_offset_floats": offset,
                           "max_rel_err": e})
            log(f"  lookahead T={rt} B={rb} H={rh}, x {offset} float(s) off its "
                f"allocation: max|d| {e:.2e} of the largest output (<= {LOOKAHEAD_RTOL})")
    finally:
        set_f32_flags(saved)
    torch.cuda.synchronize()
    bound_ms = 2 * t * b * h * 4 / PEAK_BYTES_PER_S * 1e3
    launches = la.lookahead.launches - n0
    log(f"  lookahead T={t} B={b} H={h} C={c}: stencil {times['ms']:.4f} ms against the "
        f"byte bound {bound_ms:.4f} ms ({100 * bound_ms / times['ms']:.1f}%); past walk "
        f"(dx) {times['dx_ms']:.4f} ms; plain (stacked) {times['plain_ms']:.3f} ms; "
        f"F.conv1d(groups=H) {times['library_ms']:.4f} ms; dw (C passes) "
        f"{times['dw_ms']:.3f} ms; max|d| of the largest output: forward {fwd_rel:.2e}, "
        f"dx {past_rel:.2e}, conv1d {lib_rel:.2e} (<= {LOOKAHEAD_RTOL}) [{card}]")
    errors = [fwd_rel, past_rel] + [r["max_rel_err"] for r in ragged]
    if not all(e <= LOOKAHEAD_RTOL for e in errors):
        raise AssertionError(f"phase 11c: the stencil differs from its plain version: {errors}")
    return {"name": "lookahead_stencil_kernel", "source": "danspeech_tpu_torch/csrc/lookahead.cu",
            "replaces": "none (danspeech_tpu/ops/conv.py:lookahead, fused by XLA)",
            "shape": {"T": t, "B": b, "H": h, "C": c}, **times, "bound_ms": bound_ms,
            "bound_by": "bytes", "max_rel_err": max(fwd_rel, past_rel),
            "library": "F.conv1d(groups=H), TF32 off", "library_max_rel_err": lib_rel,
            "ragged": ragged, "launches": launches, "card": card}


def burst_recording(rng, seconds=VIDEO_S):
    """Quiet stretches of 1.5-3 s between bursts of speech-level noise of 2-6
    s, ``seconds`` long: what energy_vad_segments cuts into utterances."""
    parts, n, total = [], 0, int(seconds * RATE)
    while n < total:
        quiet, loud = int(rng.uniform(1.5, 3.0) * RATE), int(rng.uniform(2.0, 6.0) * RATE)
        parts += [np.zeros(quiet), rng.normal(size=loud) * 3000.0]
        n += quiet + loud
    return np.concatenate(parts)[:total]


class Recorded:
    """Record every call of a class's method (its arguments and result)
    while in the ``with`` block."""

    def __init__(self, cls, name):
        self.cls, self.name, self.calls = cls, name, []

    def __enter__(self):
        inner = self.inner = getattr(self.cls, self.name)
        calls = self.calls

        def wrapper(obj, *args, **kw):
            res = inner(obj, *args, **kw)
            calls.append((args, kw, res))
            return res

        setattr(self.cls, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.inner)


def phase_gallery(card):
    """11b: the eight twins of ``danspeech_tpu_torch/examples`` through
    ``main(argv)`` on CUDA over seeded inputs written to a temp dir, each
    against the port's API called directly on the same model and rows."""
    import _thread
    import contextlib
    import io

    import torch.distributed as dist

    from danspeech_tpu_torch import MultiStreamTranscriber, Recognizer
    from danspeech_tpu_torch.audio import load_audio, load_audio_pcm16, load_audio_wavPCM
    from danspeech_tpu_torch.audio.dsp import energy_vad_segments
    from danspeech_tpu_torch.decode.device_lm import pack_device_lm
    from danspeech_tpu_torch.decode.lm import load_arpa
    from danspeech_tpu_torch.engine import DanSpeechRecognizer
    from danspeech_tpu_torch.examples import (
        batch_serving, device_beam_and_long_form, multi_stream_server,
        real_time_streaming_example, run_recognize, stream_example, train_finetune,
        video_transcribe_simulation)
    from danspeech_tpu_torch.models import DeepSpeechConfig, DeepSpeechModel
    from danspeech_tpu_torch.models.checkpoint import flatten_tree
    from danspeech_tpu_torch.pretrained_models import CustomModel

    failures, twins = [], {}

    def check(name, ok, msg):
        twins[name].setdefault("checks", []).append(msg if ok else f"FAILED: {msg}")
        log(f"    {'ok' if ok else 'FAILED'}: {msg}")
        if not ok:
            failures.append(f"{name}: {msg}")

    def run(name, module, argv):
        """One twin through main(argv) on CUDA: its wall time and the kernel
        launches read around it; what it prints is kept out of the log."""
        zero_launches()
        chains0 = read_chains()
        buf = io.StringIO()
        watchdog = threading.Timer(GALLERY_WATCHDOG_S, _thread.interrupt_main)
        watchdog.daemon = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        watchdog.start()
        try:
            with contextlib.redirect_stdout(buf):
                res = module.main([*argv, "--device", "cuda"])
            torch.cuda.synchronize()
        finally:
            watchdog.cancel()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in read_launches().items() if v}
        chains = {k: v - chains0[k] for k, v in read_chains().items() if v - chains0[k]}
        printed = buf.getvalue().splitlines()
        twins[name] = {"wall_s": wall, "launches": counts, "chains": chains,
                       "lines_printed": len(printed)}
        log(f"  {name}: {wall:.2f} s, launches {counts}, {len(printed)} lines printed, the "
            f"first: {printed[0][:80] if printed else ''!r} [{card}]")
        return res

    t_phase = time.perf_counter()
    waves = seeded_waveforms(np.random.default_rng(0), 128)  # phase 4's first batch
    out = phase_spectra(card, waves)
    config = DeepSpeechConfig(**FLAGSHIP)
    labels = config.labels
    with tempfile.TemporaryDirectory() as tmp:
        # the inputs, from the seeds of the phases that made them before
        wav_dir = os.path.join(tmp, "wavs")
        os.makedirs(wav_dir)
        paths = [write_pcm(os.path.join(wav_dir, f"w{i:03d}.wav"), w) for i, w in enumerate(waves)]
        pth = os.path.join(tmp, "DanSpeechPrimary.pth")
        torch.save(reference_package(config, sharpened(
            DeepSpeechModel.init_random(config, seed=0)).params), pth)  # phase 9's, fc x128
        arpa = os.path.join(tmp, "synthetic_3gram.arpa")
        synthetic_lm_arpa(arpa, labels, seed=9)  # phase 8's
        rng = np.random.default_rng(12)
        video = write_pcm(os.path.join(tmp, "long.wav"), burst_recording(rng))
        phrases = write_pcm(os.path.join(tmp, "phrases.wav"), np.concatenate(
            [np.zeros(RATE), rng.normal(size=3 * RATE) * 3000.0, np.zeros(2 * RATE),
             rng.normal(size=2 * RATE) * 3000.0, np.zeros(2 * RATE)]))
        one = os.path.join(tmp, "seeded.wav")
        seeded_wav(one, np.random.default_rng(7))  # phase 5's
        manifest = seeded_manifest(tmp, rng, labels, TRAIN_BATCH, hi_s=8.0)
        model = CustomModel(pth)
        audio0 = load_audio(paths[0])

        # batch_serving: the flagship package over the 128 WAVs
        res = run("batch_serving", batch_serving, ["--wav-dir", wav_dir, "--pth", pth])
        rec = Recognizer(model=model)
        groups = len(rec.danspeech_recognizer._plan_groups(waves))
        b3 = twins["batch_serving"]["launches"].get("gru_bidi_fused", 0)
        check("batch_serving", res["texts"] == rec.recognize_batch(
            [load_audio_pcm16(p) for p in paths]), "transcripts equal recognize_batch's")
        check("batch_serving", b3 == 2 * config.rnn_layers * groups,
              f"{b3} gru_bidi_fused launches = {config.rnn_layers} a dispatch group x "
              f"{groups} groups x 2 calls")
        twins["batch_serving"].update(audio_s=res["audio_s"], timed_wall_s=res["wall_s"],
                                      audio_s_per_s=res["audio_s_per_s"], groups=groups)
        log(f"    timed recognize_batch: {res['audio_s']:.2f} audio-s in {res['wall_s']:.3f} s "
            f"= {res['audio_s_per_s']:.1f} audio-s/s [{card}]")

        # run_recognize: greedy, the LM beam and every beam of one row
        res = run("run_recognize", run_recognize, ["--wav", paths[0], "--pth", pth,
                                                   "--arpa", arpa])
        greedy = rec.recognize(audio0)
        rec.update_decoder(lm=arpa)
        check("run_recognize", res["greedy"] == greedy and res["beam"] == rec.recognize(audio0)
              and res["all_beams"] == rec.recognize(audio0, show_all=True),
              f"greedy, beam and {len(res['all_beams'] or [])} beams equal recognize's")
        del rec

        # device_beam_and_long_form at its demo width (2x96) with phase 8's LM
        res = run("device_beam_and_long_form", device_beam_and_long_form,
                  ["--wav", paths[0], "--arpa", arpa])
        demo = DeepSpeechModel.init_random(DeepSpeechConfig(**device_beam_and_long_form.DEMO),
                                           seed=3)
        rec = Recognizer(model=demo, lm=arpa, alpha=1.0, beta=0.3)
        rec.update_decoder(beam_width=16)
        host = rec.recognize(audio0)
        rec.update_decoder(backend="device")
        dev = rec.recognize(audio0)
        check("device_beam_and_long_form", (res["host"], res["device"]) == (host, dev),
              "host and device beams equal recognize's")
        check("device_beam_and_long_form", res["sharded"] == res["device"],
              "the sharded beam equals the device beam (world size 1)")
        if host != dev:  # a float32 near tie, settled as phase 8 settles them (C16)
            probs, out_lens, _, _ = group_forward(rec.danspeech_recognizer, [audio0])
            dlm = pack_device_lm(load_arpa(arpa), labels, device="cuda")
            ref = device_tops(probs[:1].double(), [int(out_lens[0])], dlm, labels, beam=16,
                              alpha=1.0, beta=0.3)[0][0]
            check("device_beam_and_long_form", ref == host,
                  "host and device beams differ; the float64 search picks the host's")
        else:
            check("device_beam_and_long_form", True, "host and device beams agree")
        long_form = Recognizer(model=demo).recognize_long_form(np.concatenate([audio0] * 4))
        dist.destroy_process_group()
        check("device_beam_and_long_form", res["long_form"] == long_form,
              "the long form equals recognize_long_form's")
        del rec

        # multi_stream_server at its demo width (5x800 uni), 8 streams of 1 s chunks
        res = run("multi_stream_server", multi_stream_server, ["--wav-dir", wav_dir])
        chunk = 16 * 1000
        streams = multi_stream_server.session_streams(
            [load_audio_wavPCM(p) for p in paths], 8, chunk)
        ms = MultiStreamTranscriber(multi_stream_server.demo_stream_model(), n_streams=8)
        ref = [ms.step([s[i * chunk:(i + 1) * chunk] for s in streams], is_first=i == 0,
                       is_last=i == multi_stream_server.N_CHUNKS - 1)
               for i in range(multi_stream_server.N_CHUNKS)]
        check("multi_stream_server", res == ref, "every step's transcripts equal "
              "MultiStreamTranscriber.step's on the same cohorts")
        del ms

        # stream_example: two phrases at TestModel's shape (5x400)
        with Recorded(Recognizer, "recognize") as calls:
            res = run("stream_example", stream_example,
                      ["--wav", phrases, "--phrases", "2", "--random-weights"])
        rec = Recognizer(model=DeepSpeechModel.init_random(
            DeepSpeechConfig(**stream_example.TEST_MODEL), seed=0))
        check("stream_example", len(res) == 2 and res == [rec.recognize(a[0]) for a, _, _
                                                           in calls.calls],
              f"{len(res)} phrases, each equal to recognize of its samples")

        # real_time_streaming_example: CPUStreamingRNN's and TestModel's shapes
        with Recorded(DanSpeechRecognizer, "streaming_transcribe") as calls:
            res = run("real_time_streaming_example", real_time_streaming_example,
                      ["--wav", one, "--phrases", "1", "--random-weights"])
        smodel = DeepSpeechModel.init_random(
            DeepSpeechConfig(**real_time_streaming_example.CPU_STREAMING), seed=0)
        sec = DeepSpeechModel.init_random(
            DeepSpeechConfig(**real_time_streaming_example.TEST_MODEL), seed=1)
        rec = Recognizer(model=smodel)
        rec.enable_real_time_streaming(smodel, string_parts=False, secondary_model=sec)
        replay = [rec.danspeech_recognizer.streaming_transcribe(*a, **kw)
                  for a, kw, _ in calls.calls]
        check("real_time_streaming_example",
              bool(res) and res[-1][0] and replay == [r for _, _, r in calls.calls],
              f"{len(res) - 1} partials and a final; {len(calls.calls)} chunks sent again "
              "through streaming_transcribe give the same outputs")
        del rec

        # video_transcribe_simulation: the flagship package and phase 8's LM
        res = run("video_transcribe_simulation", video_transcribe_simulation,
                  [video, "--pth", pth, "--arpa", arpa])
        audio = load_audio(video)
        ranges = energy_vad_segments(audio, step=1024, energy_threshold=700.0,
                                     max_pause_steps=12, min_segment_samples=16000)
        rec = Recognizer(model=model, lm=arpa, alpha=video_transcribe_simulation.ALPHA,
                         beta=video_transcribe_simulation.BETA,
                         beam_width=video_transcribe_simulation.BEAM)
        ref = []
        for i in range(0, len(ranges), 16):
            ref += rec.recognize_batch([audio[a:b] for a, b in ranges[i:i + 16]])
        check("video_transcribe_simulation", res["ranges"] == ranges and len(ranges) > 1
              and res["segments"] == ref,
              f"{len(ranges)} segments of {VIDEO_S:.0f} s, each transcript equal to "
              "recognize_batch's")
        twins["video_transcribe_simulation"]["segments"] = len(ranges)
        del rec

        # train_finetune: the flagship package, 2 layers frozen, one epoch of 32 rows
        export = os.path.join(tmp, "finetuned.dsz")
        res = run("train_finetune", train_finetune,
                  [manifest, "--finetune-from", pth, "--freeze-layers", "2", "--epochs", "1",
                   "--batch-size", str(TRAIN_BATCH), "--checkpoint-dir",
                   os.path.join(tmp, "ckpt"), "--export", export])
        tuned, start = flatten_tree(CustomModel(export).params), flatten_tree(model.params)
        frozen = [k for k in start if k.startswith(("conv.0.", "conv.1."))]
        loss = float(res["log"][0].split("loss ")[1].split()[0])
        check("train_finetune", np.isfinite(loss) and frozen
              and all(np.array_equal(tuned[k], start[k]) for k in frozen)
              and all(not np.array_equal(tuned[k], start[k]) for k in tuned
                      if k.startswith("rnns.") and k.endswith("w_hh")),
              f"loss {loss:.4f}; the frozen conv blocks equal the package's, every "
              "recurrent weight moved")
        twins["train_finetune"]["loss"] = loss
        res = run("run_recognize (finetuned)", run_recognize, ["--wav", paths[0], "--pth",
                                                               export])
        check("run_recognize (finetuned)", res["greedy"] == Recognizer(
            model=CustomModel(export)).recognize(audio0) and res["beam"] is None,
              "the exported model's greedy transcript equals recognize's; the zoo LM not "
              "in the cache, the beam skipped")
    torch.cuda.empty_cache()

    totals: dict = {}
    for t in twins.values():
        for k, v in t["launches"].items():
            totals[k] = totals.get(k, 0) + v
    for name in ("gru_scan", "gru_bidi_fused", "gru_bwd_scan"):
        if not totals.get(name):
            failures.append(f"{name} was launched no time through the gallery")
    # gru_scan_bidi's persistent launches are gru_scan_persist_kernel's,
    # counted on gru_scan: B2 ran where a gru_scan launch walked two chains
    if sum(t["chains"].get("gru_scan", 0) for t in twins.values()) <= totals.get("gru_scan"):
        failures.append("gru_scan_bidi was launched no time through the gallery")
    out.update(card=card, twins=twins, launches=totals,
               wall_s=time.perf_counter() - t_phase)
    log(f"  phase 11: {out['wall_s']:.1f} s; launches through the twins {totals} [{card}]")
    if failures:
        raise AssertionError(f"phase 11: {len(failures)} checks failed: {failures}")
    return out


# ---------------------------------------------------------------------------
# Phase 12: float32 on the card (the float32 variants of the nine kernels)
# ---------------------------------------------------------------------------

# H100 SXM, float32 on the CUDA cores (NVIDIA data sheet): the tensor cores
# have no float32 x float32 shape, and TF32 is not float32
PEAK_FP32_FLOPS = 67e12
# a float32 entry against its plain version on the card, TF32 off for the
# plain one: the same float32 operands, FFMA sums against cuBLAS's, so the
# two differ by the order of the sums only (about 1e-7 of a value a
# product), carried on through the recurrence; held, as the bf16 checks
# are, to this times max(1, max|ref|)
F32_ATOL = 1e-4
# probabilities of the float32 paths, the card's kernels against the plain
# GRU on the card and against the port on the CPU (other conv, FFT and GEMM
# orders besides): the same rounding through 9 layers and the head. A frame's
# argmax flips only where two classes lie within that of each other
F32_PROB_ATOL = 1e-4
F32_ARGMAX_MIN = 0.999
# a transcript that differs between the card and the CPU passes only where
# every frame whose argmax differs is a near tie on the CPU: its two largest
# probabilities within F32_TIE of each other
F32_TIE = 1e-4
# the float32 train step's gradients, kernel path against plain path: the
# relative L2 error of each parameter group (float32 throughout)
F32_GRAD_REL = 1e-3
F32_ROWS_ON_CPU = 4
F32_STREAM_ROWS = 32
# the float32 cohort: S streams stepped through B1's float32 variant at B = S
F32_COHORT = 64
F32_FLAGS = ("highest", False)  # what the float32 modes run with: no TF32
# the LSTM and tanh-RNN kernels' outputs: (names, how many are streams over
# (T, B, H), the rest final states)
RNN_F32_STREAMS = {
    "lstm_scan": (("out", "h_last", "c_last"), 1),
    "lstm_scan_with_cell": (("out", "c_seq", "h_last", "c_last"), 2),
    "lstm_bwd_scan": (("dg4", "dh0", "dc0"), 1),
    "rnn_tanh_scan": (("out", "h_last"), 1),
    "rnn_tanh_bwd_scan": (("dpre", "dh0"), 1),
}
USER_FLAGS = ("high", True)     # a user's process that allows TF32 everywhere


def f32_flags():
    return torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32


def set_f32_flags(flags):
    torch.set_float32_matmul_precision(flags[0])
    torch.backends.cudnn.allow_tf32 = flags[1]


class FlagsSeen:
    """Patches the entry points of a float32 path to record the float32
    flags in force when each is called: what a product under them runs
    with. ``targets`` are (module, attribute) pairs."""

    def __init__(self, targets):
        self.targets, self.seen, self._saved = targets, [], []

    def __enter__(self):
        for mod, name in self.targets:
            fn = getattr(mod, name)

            def wrapped(*a, _fn=fn, _name=name, **k):
                self.seen.append((_name, *f32_flags()))
                return _fn(*a, **k)

            self._saved.append((mod, name, fn))
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def require(self, label):
        """Every recorded call ran with TF32 off, and there was one."""
        bad = [s for s in self.seen if tuple(s[1:]) != F32_FLAGS]
        log(f"  {label}: {len(self.seen)} calls of "
            f"{sorted({s[0] for s in self.seen})} under the float32 flags "
            f"(matmul precision, cuDNN TF32) = {F32_FLAGS}; the process holds {f32_flags()}")
        if not self.seen or bad:
            raise AssertionError(f"{label}: a float32 path ran under TF32: {bad[:3]}")
        return len(self.seen)


def tf32_probe(scope):
    """A product and a convolution whose results TF32 would change, against
    float64, inside ``scope()`` and outside it (where the process allows
    TF32). TF32's 10 mantissa bits move them by about 1e-4 of their largest
    value, full float32 by about 1e-7."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(12)
    a = torch.randn(512, 4096, generator=gen, device="cuda")
    b = torch.randn(4096, 512, generator=gen, device="cuda")
    x = torch.randn(8, 32, 64, 64, generator=gen, device="cuda")
    w = torch.randn(32, 32, 5, 5, generator=gen, device="cuda")
    ref_mm = a.double() @ b.double()
    ref_conv = F.conv2d(x.double(), w.double(), padding=2)

    def errs():
        mm = (a @ b).double()
        cv = F.conv2d(x, w, padding=2).double()
        return {"matmul": float((mm - ref_mm).abs().max() / ref_mm.abs().max()),
                "conv": float((cv - ref_conv).abs().max() / ref_conv.abs().max())}

    outside = errs()
    with scope():
        inside = errs()
    return inside, outside


def f32_bound(flops, nbytes):
    """(bound_ms, bound_by): float32 operations over the FP32 peak against
    bytes over the memory rate."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def f32_bounds(kind, t, b, h, lengths, d=0, chains=1):
    """(bound_ms, bound_by) of one float32 call, as phase 3 counts the bf16
    ones with 4-byte elements, over the valid steps: B3's projection and
    both recurrences, B1, B2, B5, B6 and B8 one product a chain, B4 and B7
    two products a chain (the walk and the gate recompute), B9 one (tanh'
    comes off the stored stream)."""
    valid = int(sum(lengths))
    if kind in RNN_F32_STREAMS:
        gates = 4 if kind.startswith("lstm") else 1
        g = gates * h
        products = 2 if kind == "lstm_bwd_scan" else 1
        # per chain: w_hh, then the streams each kind reads over the valid
        # steps and writes over all steps, and its states
        per = h * g + {
            "lstm_scan": valid * g + g + t * b * h + 4 * b * h,
            "lstm_scan_with_cell": valid * g + g + 2 * t * b * h + 4 * b * h,
            "lstm_bwd_scan": valid * (g + 3 * h) + g + t * b * g + 2 * b * h,
            "rnn_tanh_scan": valid * h + t * b * h + b * h,
            "rnn_tanh_bwd_scan": valid * 2 * h + t * b * h + b * h,
        }[kind]
        return f32_bound(chains * 2 * products * valid * h * g, chains * 4 * per + 4 * b)
    if kind == "gru_bidi_fused":
        return f32_bound(2 * 2 * valid * (d + h) * 3 * h,
                         4 * (valid * d + 2 * (d + h) * 3 * h + 12 * h + 2 * t * b * h
                              + 2 * b * h) + 4 * b)
    if kind in ("gru_scan", "gru_scan_bidi"):
        return f32_bound(chains * 2 * valid * h * 3 * h,
                         chains * 4 * (valid * 3 * h + 3 * h * h + 6 * h + t * b * h
                                       + 2 * b * h) + 4 * b)
    return f32_bound(chains * 2 * 2 * valid * h * 3 * h,
                     chains * 4 * (valid * (3 * h + 2 * h) + 3 * h * h + 6 * h
                                   + t * b * 4 * h + 2 * b * h) + 4 * b)


def check_f32(name, label, run, plain, names, pad_of, lens, t, design="step", ref=None):
    """One float32 entry against its plain version (TF32 off) on the same
    inputs (``ref``, its outputs, where already computed): every output held
    to F32_ATOL x max(1, max|ref|), float32, finite, exact zeros past a
    row's length (``pad_of`` outputs); the call must take the float32
    variant in ``design``. Returns the result and the kernel's outputs'
    errors."""
    from danspeech_tpu_torch.ops import precision

    wrapper = kernel_wrappers()[name]
    if ref is None:
        with precision.full_float32("cuda"):
            ref = plain()
    torch.cuda.synchronize()
    before = (wrapper.launches, wrapper.dtype_counts["float32"], dict(wrapper.design_counts))
    got = run()
    torch.cuda.synchronize()
    n = wrapper.launches - before[0]
    if n < 1 or wrapper.dtype_counts["float32"] - before[1] != n \
            or wrapper.design_counts[design] - before[2][design] != n:
        raise AssertionError(f"{name} {label}: the call did not take the float32 variant's "
                             f"{design} design")
    errs, worst = compare_outputs(f"{name} (float32) {label}", names, got, ref, F32_ATOL)
    if any(g.dtype != torch.float32 for g in got):
        raise AssertionError(f"{name} {label}: outputs not float32")
    pad = torch.arange(t, device="cuda")[:, None] >= lens[None, :].long()
    for g in got[:pad_of]:
        if pad.any() and float(g[pad].abs().max()) != 0.0:
            raise AssertionError(f"{name} (float32) {label}: non-zero past a row's length")
    log(f"  {name}[float32, {design}] {label}: max|err| "
        + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f" (atol {F32_ATOL} x max(1, max|ref|))")
    return {"label": label, "max_abs_err": worst, "errs": errs, "atol": F32_ATOL,
            "design": design}


def check_f32_designs(name, label, run, plain, names, pad_of, lens, t):
    """A float32 entry of a walk with both designs (B1-B9) against one
    result of its plain version: ``run(design)`` calls it. Returns the
    persistent design's result with the step design's inside."""
    from danspeech_tpu_torch.ops import precision

    with precision.full_float32("cuda"):
        ref = plain()
    res = {d: check_f32(name, label, lambda d=d: run(d), None, names, pad_of, lens, t,
                        design=d, ref=ref) for d in DESIGNS}
    main = res["persistent"]
    main["step_design"] = res["step"]
    main["max_abs_err"] = max(r["max_abs_err"] for r in res.values())
    return main


def as_read(x, spec: str) -> str:
    """``x`` in ``spec``, or "not read" where it is None."""
    return "not read" if x is None else format(x, spec)


def call_split(label, fn, kernel, launches):
    """One call of ``fn`` under torch.profiler (:func:`profile_events`): its
    wall time on the host, the device time of the kernels whose name holds
    ``kernel`` and of all device events, their count, and the device's span
    from the first one's start to the last one's end; what the span holds
    beyond the events is the device idle between launches, what the wall
    time holds beyond the span is the host before the first launch and
    after the last. Where the reading holds other than ``launches`` of
    ``kernel``, every device number is None: a trace that lost events says
    nothing of the device."""
    r = profile_events(fn, kernel, launches)
    events, wall = r["events"], r["wall_ms"]
    res = {"wall_ms": wall, "kernel_launches": r["count"], "launches": len(events),
           "whole": r["whole"], "device_busy_ms": None, "device_span_ms": None,
           "kernel_ms": None, "idle_between_launches_ms": None, "host_outside_span_ms": None}
    if r["whole"]:
        busy = sum(e - s for _, s, e in events) / 1e3
        span = (max(e for *_, e in events) - min(s for _, s, _ in events)) / 1e3
        res.update(device_busy_ms=busy, device_span_ms=span,
                   kernel_ms=sum(e - s for n, s, e in events if kernel in n) / 1e3,
                   idle_between_launches_ms=span - busy, host_outside_span_ms=wall - span)
    log(f"    one call, {label}: wall {wall:.3f} ms; device busy "
        f"{as_read(res['device_busy_ms'], '.3f')} ms over {len(events)} launches, "
        f"{as_read(res['kernel_ms'], '.3f')} ms of it in {r['count']} (of {launches}) launches "
        f"of {kernel}; device span {as_read(res['device_span_ms'], '.3f')} ms, idle between "
        f"launches {as_read(res['idle_between_launches_ms'], '.3f')} ms, host outside the span "
        f"{as_read(res['host_outside_span_ms'], '.3f')} ms")
    return res


def kernel_reading(fn, kernel, launches, steps):
    """The profiler's device time of ``kernel`` in one call of ``fn``, which
    launches it ``launches`` times, and that over ``steps`` in µs a step:
    both None where the reading kept another count of its launches (a
    reading short of them is not scaled up). Returns them with the count
    the reading kept and all the device events it kept."""
    r = profile_events(fn, kernel, launches)
    ms = sum(e - s for n, s, e in r["events"] if kernel in n) / 1e3 if r["whole"] else None
    return {"kernel_ms": ms, "kernel_us_a_step": None if ms is None else ms * 1e3 / steps,
            "launches_profiled": r["count"], "device_events_profiled": len(r["events"])}


def time_f32(res, designs, plain, library, bound, library_name="nn.GRU"):
    """A float32 entry timed by CUDA events: the first design of
    ``designs`` before the plain version (TF32 off) and one cuDNN float32
    call (TF32 off) and again after them, each other design once in
    between; the bound; each design's µs a step by CUDA events (its call's
    time over the steps it walks, ``us_a_step``) and, beside it, its
    :func:`kernel_reading` (the profiler's, unscaled: None where it dropped
    launches). ``designs`` maps a design to (call, its walk's kernel as the
    profiler names it, that kernel's launches a call, the steps it walks).
    The first design's numbers go under their own keys, another's under
    ``{design}_design_`` and the key."""
    from danspeech_tpu_torch.ops import precision

    (main, (run, *_)), *others = designs.items()
    a = time_ms(run, iters=2)
    for d, (fn, *_) in others:
        res[f"{d}_design_ms"] = time_ms(fn, iters=2)
    with precision.full_float32("cuda"):
        res["plain_ms"] = time_ms(plain, iters=1)
        res["library_ms"] = library()
    res["ms"] = 0.5 * (a + time_ms(run, iters=2))
    res["bound_ms"], res["bound_by"] = bound
    for d, (fn, kernel, launches, steps) in designs.items():
        tag = "" if d == main else f"{d}_design_"
        res[tag + "us_a_step"] = res[tag + "ms"] * 1e3 / steps
        got = kernel_reading(fn, kernel, launches, steps)
        res.update({tag + k: v for k, v in got.items()})
        log(f"    float32 {d} design: ms={res[tag + 'ms']:.3f} = "
            f"{res[tag + 'us_a_step']:.1f} us a step by CUDA events over {steps}; the profiler's "
            f"{kernel}: {as_read(got['kernel_ms'], '.3f')} ms = "
            f"{as_read(got['kernel_us_a_step'], '.1f')} us a step over {steps} "
            f"({got['launches_profiled']} of {launches} launches kept, "
            f"{got['device_events_profiled']} device events)")
    log(f"    plain_ms={res['plain_ms']:.3f} library_ms(cuDNN {library_name} float32, "
        f"TF32 off)={res['library_ms']:.3f} bound_ms={res['bound_ms']:.4f} "
        f"({res['bound_by']}, FP32 {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s)")
    return res


# the float32 walks' kernels as the profiler names them: (persistent, step)
F32_WALK_KERNELS = {
    **dict.fromkeys(("gru_bidi_fused", "gru_scan", "gru_scan_bidi"),
                    ("gru_f32_persist_kernel", "gru_f32_step_kernel")),
    "gru_bwd_scan": ("gru_f32_bwd_persist_kernel", "gru_f32_bwd_step_kernel"),
    **dict.fromkeys(("lstm_scan", "lstm_scan_with_cell"),
                    ("lstm_f32_persist_kernel", "lstm_f32_step_kernel")),
    "lstm_bwd_scan": ("lstm_f32_bwd_persist_kernel", "lstm_f32_bwd_step_kernel"),
    "rnn_tanh_scan": ("rnn_tanh_f32_persist_kernel", "rnn_tanh_f32_step_kernel"),
    "rnn_tanh_bwd_scan": ("rnn_tanh_f32_bwd_persist_kernel", "rnn_tanh_f32_bwd_step_kernel"),
}


def time_f32_forward(res, run, plain, library, bound, plan, t, steps, walk=None):
    """B1, B2, B3 in float32 by :func:`time_f32`: the persistent design
    (one launch of its walk over ``steps``) first, then the step design
    (``t`` launches); µs a step by CUDA events over each design's walk: the
    call's time for B1 and B2, for B3 that of ``walk(design)``, its
    recurrence without the projection (B2's entry on the layer's projected
    gx, which plans and launches the same walk); the plan's resident
    share."""
    runs = {d: (lambda d=d: run(d)) for d in DESIGNS}
    persistent, step = F32_WALK_KERNELS["gru_scan"]
    time_f32(res, {"persistent": (runs["persistent"], persistent, 1, steps),
                   "step": (runs["step"], step, t, t)},
             plain, library, bound)
    for d, walked in (("persistent", steps), ("step", t)):
        tag = "" if d == "persistent" else "step_design_"
        ms = res[f"{tag}ms"]
        if walk is not None:
            ms = res[f"{tag}walk_ms"] = time_ms(lambda d=d: walk(d), iters=2)
        res[f"{tag}us_a_step"] = ms * 1e3 / walked
    res.update(design="persistent", **f32_plan_fields(plan))
    log(f"    float32 persistent: {res['us_a_step']:.1f} us a step by CUDA events over "
        f"{steps} walked{' (the walk alone)' if walk else ''}, {plan.product} product, "
        f"{plan.grid} blocks of {plan.threads}, resident share {plan.resident_share:.3f}; "
        f"step design {res['step_design_us_a_step']:.1f} us a step over {t} launches")
    return res


def f32_plan_fields(plan):
    """A float32 walk's plan as phase 12a records it beside its times."""
    return {"resident_share": plan.resident_share,
            "plan": {k: getattr(plan, k) for k in (
                "walk", "product", "chains", "units", "grid", "threads", "k_splits",
                "rows_per_pass", "chunk_depth", "stages", "resident_depth", "padded_depth",
                "smem_bytes")}}


def time_f32_pair(res, pair, walked, t_steps, plan):
    """The pair of a layer of a float32 walk (B4-B8) timed by CUDA
    events in each design, persistent first, into ``res`` (the chain's
    entry): ms a chain, and µs a step over the steps the persistent launch
    walks (``walked``) and the step design's launches (``t_steps``); the
    pair's plan."""
    ms = time_ms(lambda: pair("persistent"), iters=2)
    step_ms = time_ms(lambda: pair("step"), iters=2)
    ms = 0.5 * (ms + time_ms(lambda: pair("persistent"), iters=2))
    res.update(pair_ms_per_chain=0.5 * ms, pair_us_a_step=ms * 1e3 / walked,
               step_design_pair_ms_per_chain=0.5 * step_ms,
               step_design_pair_us_a_step=step_ms * 1e3 / t_steps,
               pair_plan=f32_plan_fields(plan))
    log(f"    float32 pair: persistent {res['pair_ms_per_chain']:.3f} ms a chain "
        f"({res['pair_us_a_step']:.1f} us a step over {walked}, {plan.grid} blocks of "
        f"{plan.threads}, resident share {plan.resident_share:.3f}); step design "
        f"{res['step_design_pair_ms_per_chain']:.3f} ms a chain "
        f"({res['step_design_pair_us_a_step']:.1f} us a step over {t_steps} launches)")


# the float32 GRU forward walk's batches around the plan's switch from the
# small-B product to the tiled one (persist_plan.F32_DOT_ROWS = 8) and its
# tile and pass boundaries, each with carried states where the entry takes
# them
F32_BOUNDARY_BATCHES = (8, 9, 63, 64, 65, 128)


def boundary_lengths(b, t):
    """Ragged lengths over ``b`` rows: the first row the whole of ``t``,
    the others spread over 0 .. t."""
    return [t] + [(7 * i) % (t + 1) for i in range(1, b)]


def phase_f32_kernels(card):
    """12a: each float32 entry against its plain version on the card at
    ragged small shapes and at the layer shapes, the layer shapes timed; B1,
    B2 and B3 in both designs, also at batches around the plan's switch and
    boundaries, and one B1 call at the streaming chunk split by the
    profiler in each design."""
    from danspeech_tpu_torch.ops import gru_cuda, persist_plan, precision, walks

    gen = torch.Generator(device="cuda")
    gen.manual_seed(120)
    out = {k: [] for k in ("gru_bidi_fused", "gru_scan", "gru_scan_bidi", "gru_bwd_scan")}
    info = walks.device_info(torch.device("cuda", torch.cuda.current_device()))

    # B3: the fused layer, h0 = 0
    fused_names = ("out_f", "out_b", "h_last_f", "h_last_b")
    cases = [(37, 5, 96, 64, [37, 1, 20, 36, 5], False),
             (9, 3, 50, 100, [9, 1, 4], False),  # H, D no multiples of 4 or 8
             (1, 2, 50, 72, [1, 0], False),      # T = 1, a row of length 0
             (7, 150, 64, 72, [7, 1] + [1 + (i % 7) for i in range(148)], False)]
    cases += [(STREAM_T, b, 1200, 1200, boundary_lengths(b, STREAM_T), False)
              for b in F32_BOUNDARY_BATCHES]
    cases += [(401, 128, 2016, 1200, "flag", True), (401, 128, 1200, 1200, "flag", True)]
    for t, b, d, h, lengths, timed in cases:
        if lengths == "flag":
            lengths = np.random.default_rng(d).integers(1, 402, size=b)
            lengths[0], lengths[1] = 401, 1
            lengths = lengths.tolist()
        args = gru_layer_inputs(gen, t, b, d, h, lengths, dtype=torch.float32)
        label = f"T={t} B={b} D={d} H={h}"

        def run(design, args=args):
            return gru_cuda.gru_bidi_fused(*args, design=design)

        res = check_f32_designs("gru_bidi_fused", label, run,
                                lambda: gru_cuda.gru_bidi_fused_plain(*args), fused_names, 2,
                                args[1], t)
        if timed and d == 2016:
            res["label"] = "flagship layer 0"
            x, lens, w_ih_f, w_ih_b, *rest = args
            with precision.full_float32("cuda"):  # the projection, bias-free
                gx = [x @ w for w in (w_ih_f, w_ih_b)]
            h0 = torch.zeros(b, h, device="cuda")

            def walk(design, gx=gx, lens=lens, rest=rest, h0=h0):
                return gru_cuda.gru_scan_bidi(*gx, lens, *rest, h0, h0, design=design)

            time_f32_forward(res, run, lambda: gru_cuda.gru_bidi_fused_plain(*args),
                             lambda: cudnn_rnn_ms(torch.nn.GRU(d, h, bidirectional=True), gen,
                                                  t, b, h, backward=False, dtype=torch.float32),
                             f32_bounds("gru_bidi_fused", t, b, h, lengths, d=d),
                             persist_plan.plan_gru_f32_forward(h, b, 2, *info), t,
                             max(lengths), walk=walk)
            del gx, walk
        elif timed:
            res["ms"] = time_ms(lambda: run("persistent"), iters=2)
            res["step_design_ms"] = time_ms(lambda: run("step"), iters=2)
            res["bound_ms"], res["bound_by"] = f32_bounds("gru_bidi_fused", t, b, h,
                                                          lengths, d=d)
            log(f"    float32 persistent ms={res['ms']:.3f} step design "
                f"ms={res['step_design_ms']:.3f} bound_ms={res['bound_ms']:.4f}")
        out["gru_bidi_fused"].append(res)
        del args
    torch.cuda.empty_cache()

    # B1: one chain, carried h0
    uni = np.random.default_rng(2000).integers(1, 402, size=128)
    uni[0], uni[1] = 401, 1
    cases = [(13, [13, 1, 7, 12, 3], 72, False, "small", False),
             (13, [13, 1, 7, 12, 3], 72, True, "small reverse", False),
             (9, [9, 0, 4], 100, True, "small H=100", False),
             (1, [1, 0], 72, False, "small T=1", False),
             (7, [7, 1] + [1 + (i % 7) for i in range(148)], 72, False, "small B=150", False)]
    cases += [(STREAM_T, boundary_lengths(b, STREAM_T), 2000, b % 2 == 1, f"boundary B={b}",
               False) for b in F32_BOUNDARY_BATCHES]
    cases += [(401, uni.tolist(), 2000, False, "uni batch layer", True),
              (STREAM_T, [STREAM_VALID], 2000, False, "streaming step", True)]
    for t, lengths, h, reverse, label, timed in cases:
        args = scan_inputs(gen, t, lengths, h, carried=True, dtype=torch.float32)

        def run(design, args=args, reverse=reverse):
            return gru_cuda.gru_scan(*args, reverse=reverse, design=design)

        res = check_f32_designs("gru_scan", f"{label} T={t} B={len(lengths)} H={h} "
                                f"reverse={reverse}", run,
                                lambda: gru_cuda.gru_scan_plain(*args, reverse=reverse),
                                ("out", "h_last"), 1, args[1], t)
        res["label"] = label
        if timed:
            time_f32_forward(res, run, lambda: gru_cuda.gru_scan_plain(*args, reverse=reverse),
                             lambda: cudnn_rnn_ms(torch.nn.GRU(h, h), gen, t, len(lengths), h,
                                                  backward=False, dtype=torch.float32),
                             f32_bounds("gru_scan", t, len(lengths), h, lengths),
                             persist_plan.plan_gru_f32_forward(h, len(lengths), 1, *info), t,
                             max(lengths))
        if label == "streaming step":
            # where one call's time goes, in each design
            res["split"] = {d: call_split(f"B1 {d} design T={t} B=1 H={h}",
                                          lambda d=d: run(d),
                                          F32_WALK_KERNELS["gru_scan"][d == "step"],
                                          1 if d == "persistent" else t)
                            for d in DESIGNS}
        out["gru_scan"].append(res)
        del args
    torch.cuda.empty_cache()

    # B2: both chains, carried states
    bidi = np.random.default_rng(1200).integers(1, 402, size=128)
    bidi[0], bidi[1] = 401, 1
    cases = [(13, [13, 1, 7, 12, 3], 72, "small", False),
             (9, [9, 0, 4], 100, "small H=100", False),
             (1, [1, 0], 72, "small T=1", False),
             (7, [7, 1] + [1 + (i % 7) for i in range(148)], 72, "small B=150", False)]
    cases += [(STREAM_T, boundary_lengths(b, STREAM_T), 1200, f"boundary B={b}", False)
              for b in F32_BOUNDARY_BATCHES]
    cases += [(401, bidi.tolist(), 1200, "bidi batch layer", True)]
    for t, lengths, h, label, timed in cases:
        f = scan_inputs(gen, t, lengths, h, carried=True, dtype=torch.float32)
        r = scan_inputs(gen, t, lengths, h, carried=True, dtype=torch.float32)
        args = (f[0], r[0], f[1], f[2], r[2], f[3], r[3], f[4], r[4], f[5], r[5])

        def run(design, args=args):
            return gru_cuda.gru_scan_bidi(*args, design=design)

        res = check_f32_designs("gru_scan_bidi", f"{label} T={t} B={len(lengths)} H={h}",
                                run, lambda: gru_cuda.gru_scan_bidi_plain(*args),
                                ("out_f", "out_b", "h_last_f", "h_last_b"), 2, f[1], t)
        res["label"] = label
        if timed:
            time_f32_forward(res, run, lambda: gru_cuda.gru_scan_bidi_plain(*args),
                             lambda: cudnn_rnn_ms(torch.nn.GRU(h, h, bidirectional=True), gen,
                                                  t, len(lengths), h, backward=False,
                                                  dtype=torch.float32),
                             f32_bounds("gru_scan_bidi", t, len(lengths), h, lengths,
                                        chains=2),
                             persist_plan.plan_gru_f32_forward(h, len(lengths), 2, *info), t,
                             max(lengths))
        out["gru_scan_bidi"].append(res)
        del args, f, r
    torch.cuda.empty_cache()

    # B4: the backward walks, one chain or the pair of a layer, in both designs
    train = np.random.default_rng(1201).integers(1, 402, size=32)
    train[0], train[1] = 401, 1
    walk_names = ("dgx", "dghn", "dh0")
    for t, lengths, h, label, timed in (
            (13, [13, 0, 1, 7, 12], 72, "small", False),
            (1, [1, 0], 72, "small T=1", False),
            (9, [9, 1, 4], 100, "small H=100", False),
            (7, [7, 0] + [1 + (i % 7) for i in range(148)], 72, "small B=150", False),
            (401, train.tolist(), 1200, "flagship layer", True)):
        a = bwd_inputs(gen, t, lengths, h, dtype=torch.float32)
        for reverse in (True, False):
            def run(design, reverse=reverse):
                return gru_cuda.gru_bwd_scan(*a, reverse=reverse, design=design)

            def plain(reverse=reverse):
                return gru_cuda.gru_bwd_scan_plain(*a, reverse=reverse)

            res = check_f32_designs("gru_bwd_scan", f"{label} T={t} B={len(lengths)} H={h} "
                                    f"reverse={reverse}", run, plain, walk_names, 2, a[3], t)
            if timed and reverse:
                res["label"] = label
                walked = max(lengths) + 1  # and a last pass for dh0
                time_f32(res, {"persistent": (lambda: run("persistent"),
                                              F32_WALK_KERNELS["gru_bwd_scan"][0], 1, walked),
                               "step": (lambda: run("step"), F32_WALK_KERNELS["gru_bwd_scan"][1],
                                        t + 1, t + 1)},
                         plain,
                         lambda: cudnn_rnn_ms(torch.nn.GRU(h, h), gen, t, len(lengths), h,
                                              backward=True, dtype=torch.float32),
                         f32_bounds("gru_bwd_scan", t, len(lengths), h, lengths))
                res.update(design="persistent", **f32_plan_fields(
                    persist_plan.plan_gru_f32_backward(h, len(lengths), 1, *info)))
                main = res
            out["gru_bwd_scan"].append(res)
        c = bwd_inputs(gen, t, lengths, h, lens=a[3], dtype=torch.float32)

        def pair(design):
            ga, gc = gru_cuda.gru_bwd_scan_pair(a, c, True, False, design=design)
            return (*ga, *gc)

        def pair_plain():
            return (*gru_cuda.gru_bwd_scan_plain(*a, reverse=True),
                    *gru_cuda.gru_bwd_scan_plain(*c, reverse=False))

        res = check_f32_designs("gru_bwd_scan", f"{label}, the pair of a layer T={t} "
                                f"B={len(lengths)} H={h}", pair, pair_plain,
                                [f"{n} {k}" for k in "ab" for n in walk_names], 2, a[3], t)
        res["label"] = f"{label}, pair"
        if timed:
            time_f32_pair(main, pair, max(lengths) + 1, t + 1,
                          persist_plan.plan_gru_f32_backward(h, len(lengths), 2, *info))
        out["gru_bwd_scan"].append(res)
        del a, c
    torch.cuda.empty_cache()
    return out


def f32_rnn_operands(kind, gen, t, lengths, h, lens):
    """Seeded float32 operands of one chain of an LSTM or tanh-RNN kernel
    over ``lens``, drawn as phase 3 draws the bf16 ones."""
    dev = "cuda"
    b = len(lengths)
    bound = 1.0 / h ** 0.5

    def uni(*shape):
        return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * bound

    def normal(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    if kind in ("lstm_scan", "lstm_scan_with_cell"):
        return (normal(t, b, 4 * h, scale=0.5), lens, uni(h, 4 * h), uni(4 * h),
                torch.rand(b, h, generator=gen, device=dev) - 0.5,
                torch.rand(b, h, generator=gen, device=dev) - 0.5)
    if kind == "lstm_bwd_scan":
        hprev = torch.rand(t, b, h, generator=gen, device=dev) * 2 - 1
        return (normal(t, b, 4 * h, scale=0.5), hprev, normal(t, b, h), normal(t, b, h),
                lens, uni(h, 4 * h), uni(4 * h))
    if kind == "rnn_tanh_scan":
        return (normal(t, b, h, scale=0.5), lens, uni(h, h))
    out = torch.rand(t, b, h, generator=gen, device=dev) * 2 - 1
    out[torch.arange(t, device=dev)[:, None] >= lens[None, :].long()] = 0  # as the forward's
    return (out, normal(t, b, h), lens, uni(h, h))


def check_f32_rnn(kind, gen, label, t, lengths, h, timed):
    """One LSTM or tanh-RNN float32 entry against its plain version, one
    chain (a forward chain, or the walk of one) and the pair of a layer (the
    second chain walking the other way), in both designs. At the layer
    shapes (``timed``) the chain timed beside the plain version, one cuDNN
    float32 call and the FP32 bound (persistent first, the step design
    beside), and the pair's time a chain in both designs. Returns the two
    checks."""
    from danspeech_tpu_torch.ops import lstm_cuda, persist_plan, rnn_tanh_cuda, walks

    lstm = kind.startswith("lstm")
    module = lstm_cuda if lstm else rnn_tanh_cuda
    wrapper, plain = getattr(module, kind), getattr(module, f"{kind}_plain")
    backward = kind.endswith("bwd_scan")
    reverse = backward  # a forward chain, or the walk that undoes one
    names, streams = RNN_F32_STREAMS[kind]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    a = f32_rnn_operands(kind, gen, t, lengths, h, lens)
    c = f32_rnn_operands(kind, gen, t, lengths, h, lens)
    shape = f"T={t} B={len(lengths)} H={h}"

    def run(design=None):
        return wrapper(*a, reverse=reverse, design=design)

    def run_plain():
        return plain(*a, reverse=reverse)

    def pair(design=None):
        if kind in ("lstm_scan", "lstm_scan_with_cell"):
            got = lstm_cuda.lstm_scan_pair(a, c, reverse, not reverse,
                                           with_cell=kind == "lstm_scan_with_cell",
                                           design=design)
        else:
            got = getattr(module, f"{kind}_pair")(a, c, reverse, not reverse, design=design)
        return flat(*got)

    def flat(ra, rc):  # the streams of both chains first
        return (*ra[:streams], *rc[:streams], *ra[streams:], *rc[streams:])

    def pair_plain():
        return flat(run_plain(), plain(*c, reverse=not reverse))

    pair_names = [f"{n} {k}" for part in (names[:streams], names[streams:])
                  for k in "ab" for n in part]
    res = check_f32_designs(kind, f"{label} {shape}", run, run_plain, names, streams,
                            lens, t)
    pres = check_f32_designs(kind, f"{label}, the pair of a layer {shape}", pair,
                             pair_plain, pair_names, 2 * streams, lens, t)
    res["label"] = label
    pres["label"] = f"{label}, pair"
    if timed:
        lib = torch.nn.LSTM(h, h) if lstm else torch.nn.RNN(h, h, nonlinearity="tanh")
        steps = t + 1 if backward else t
        kernel = f"{'lstm' if lstm else 'rnn_tanh'}_f32_{'bwd_' if backward else ''}step_kernel"
        # the persistent walks take the longest row's steps, a backward walk
        # one more (the last pass finishes the carry)
        walked = max(lengths) + int(backward)
        designs = {"persistent": (lambda: run("persistent"), F32_WALK_KERNELS[kind][0], 1,
                                  walked),
                   "step": (lambda: run("step"), kernel, steps, steps)}
        time_f32(res, designs, run_plain,
                 lambda: cudnn_rnn_ms(lib, gen, t, len(lengths), h, backward=backward,
                                      dtype=torch.float32),
                 f32_bounds(kind, t, len(lengths), h, lengths),
                 library_name=f"nn.{type(lib).__name__}")
        info = walks.device_info(torch.device("cuda", torch.cuda.current_device()))
        walk = persist_plan.F32_WALK_OF[kind]
        res.update(design="persistent", **f32_plan_fields(
            persist_plan.plan_f32(walk, h, len(lengths), 1, *info)))
        time_f32_pair(res, pair, walked, steps,
                      persist_plan.plan_f32(walk, h, len(lengths), 2, *info))
    del a, c
    torch.cuda.empty_cache()
    return [res, pres]


def phase_f32_rnn_kernels():
    """12a, B5-B9: each LSTM and tanh-RNN float32 entry at ragged small
    shapes (B = 5 with an empty row, T = 1, H = 70 no multiple of 4 or 8,
    B = 150 over two row blocks) and at the layer shapes of LSTM5x800 /
    Tanh5x800: serving (B = 128) for the forward chains B5 and B8, training
    (B = 32) for B6 and the walks B7 and B9; one chain and a pair each. B8
    runs at both layer shapes on the paths, each with its own plan (the
    training one with four times the depth splits), so it is checked at
    both and timed at the serving one."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(121)
    serve = np.random.default_rng(800).integers(1, 402, size=128)
    train = np.random.default_rng(801).integers(1, 402, size=32)
    for lengths in (serve, train):
        lengths[0], lengths[1] = 401, 1
    # each entry's layer shapes: (label, lengths, timed)
    layer = {"lstm_scan": [("serve layer", serve, True)],
             "rnn_tanh_scan": [("serve layer", serve, True), ("train layer", train, False)],
             "lstm_scan_with_cell": [("train layer", train, True)],
             "lstm_bwd_scan": [("train layer", train, True)],
             "rnn_tanh_bwd_scan": [("train layer", train, True)]}
    out = {}
    for kind, shapes in layer.items():
        rows = []
        for t, lens, h, small in ((13, [13, 0, 1, 7, 12], 72, "small"),
                                  (1, [1, 0], 70, "small T=1"),
                                  (9, [9, 0, 4], 70, "small H=70"),
                                  (7, [7, 1] + [1 + (i % 7) for i in range(148)], 72,
                                   "small B=150")):
            rows += check_f32_rnn(kind, gen, small, t, lens, h, False)
        for label, lengths, timed in shapes:
            rows += check_f32_rnn(kind, gen, label, 401, lengths.tolist(), 800, timed)
        out[kind] = rows
    return out


# the float32 GEMM of csrc/sgemm.cuh at the shapes the paths run (label, M,
# K, N, whether both products share A): B3's projection x @ w_ih of both
# directions at the flagship's served layer 0 and layers 1-8 (T=401, B=128)
# and at its layer 0 in the train step (B=32); the gate recompute hprev @
# w_hh of B4's pair (B=32, H=1200) and of B7's (LSTM5x800, B=32, H=800)
SGEMM_SHAPES = (("a", "B3 flagship layer 0, served", 401 * 128, 2016, 3600, True),
                ("b", "B3 layers 1-8, served", 401 * 128, 1200, 3600, True),
                ("c", "B3 layer 0, train step", 401 * 32, 2016, 3600, True),
                ("d", "B4 recompute, B=32", 401 * 32, 1200, 3600, False),
                ("e", "B7 recompute, B=32", 401 * 32, 800, 3200, False))
# the GEMM against torch.matmul in full float32: max|err| over K x max|a| x
# max|b|. Two float32 sums of K products in other orders differ by about
# eps sqrt(K) of a typical product (1e-9 of that scale here); TF32's 10
# mantissa bits would give about 1e-6
SGEMM_REL = 1e-7


def gemm_operands(gen, m, k, n, shared):
    """A (M, K) shared by both products, or (2, M, K), and B (2, K, N):
    activations and weights drawn as the layers' are."""
    a = torch.randn(m if shared else 2 * m, k, generator=gen, device="cuda")
    a = a if shared else a.reshape(2, m, k)
    b = (torch.rand(2, k, n, generator=gen, device="cuda") * 2 - 1) / k ** 0.5
    return a, b


def tree_sgemm(tree):
    """The GEMM of another tree's ``csrc/sgemm.cuh`` (an older commit's,
    unpacked beside this one), built here through a C entry of its own: a
    function (a, b) -> C as :func:`gru_cuda.sgemm_f32` takes them."""
    import ctypes
    import hashlib

    from danspeech_tpu_torch.ops import cuda_build

    csrc = os.path.join(os.path.abspath(tree), "danspeech_tpu_torch", "csrc")
    out_dir = os.path.join(cuda_build.BUILD_DIR, "tree_sgemm",
                           hashlib.sha256(csrc.encode()).hexdigest()[:12])
    os.makedirs(out_dir, exist_ok=True)
    src, lib = os.path.join(out_dir, "tree_sgemm.cu"), os.path.join(out_dir, "libtree_sgemm.so")
    with open(src, "w") as f:
        f.write('#include <cuda_bf16.h>\n#include <cuda_runtime.h>\n#include <stdint.h>\n'
                'typedef __nv_bfloat16 bf16;\n'
                f'#include "{csrc}/persist.cuh"\n#include "{csrc}/sgemm.cuh"\n'
                'extern "C" int tree_sgemm_launch(const void* a0, const void* a1, '
                'const void* b0, const void* b1, void* c0, void* c1, int M, int N, int K, '
                'int nz, void* s) {\n  return sgemm_launch((const float*)a0, (const float*)a1, '
                '(const float*)b0, (const float*)b1, (float*)c0, (float*)c1, M, N, K, nz, '
                '(cudaStream_t)s);\n}\n')
    done = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"the tree's sgemm.cuh did not build:\n{done.stdout}{done.stderr}")
    for line in (done.stdout + done.stderr).splitlines():
        if "registers" in line or "spill" in line:
            log(f"  {tree}'s sgemm.cuh: {line.strip()}")
    fn = ctypes.CDLL(lib).tree_sgemm_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(a, b):
        m, k = a.shape[-2:]
        n = b.shape[-1]
        out = torch.empty((2, m, n), device="cuda")
        a0, a1 = (a, a) if a.dim() == 2 else (a[0], a[1])
        rc = fn(a0.data_ptr(), a1.data_ptr(), b[0].data_ptr(), b[1].data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), m, n, k, 2,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the tree's sgemm launch failed: CUDA error {rc}")
        return out

    return run


def phase_f32_gemm(card, against=None):
    """12a, the GEMM of csrc/sgemm.cuh alone (gru_cuda.sgemm_f32) at the
    shapes of B3's projection and B4's and B7's recompute: against
    torch.matmul in full float32 (SGEMM_REL), both timed by CUDA events in
    turns (kernel, matmul, kernel), TFLOP/s and the FP32 bound beside. With
    ``against`` (another tree's root), that tree's sgemm.cuh is built and
    timed in the same turns (old, new, new, old) and checked the same way."""
    from danspeech_tpu_torch.ops import gru_cuda, precision

    gen = torch.Generator(device="cuda")
    gen.manual_seed(122)
    old = tree_sgemm(against) if against else None
    rows = []
    for tag, label, m, k, n, shared in SGEMM_SHAPES:
        a, b = gemm_operands(gen, m, k, n, shared)
        flops = 2.0 * 2 * m * k * n
        scale = k * float(a.abs().max()) * float(b.abs().max())
        with precision.full_float32("cuda"):
            ref = torch.matmul(a, b)
            torch.cuda.synchronize()
            before = gru_cuda.sgemm_f32.launches
            got = gru_cuda.sgemm_f32(a, b)
            torch.cuda.synchronize()
            if gru_cuda.sgemm_f32.launches != before + 1:
                raise AssertionError(f"sgemm ({tag}): the call did not launch the kernel")
            err = float((got - ref).abs().max()) / scale
            res = {"shape": tag, "label": label, "M": m, "K": k, "N": n, "z": 2,
                   "a_shared": shared, "max_abs_err_rel": err, "tolerance": SGEMM_REL}
            del got
            if not err <= SGEMM_REL:
                raise AssertionError(f"sgemm ({tag}) {label}: max|err| / (K max|a| max|b|) = "
                                     f"{err:.3e} > {SGEMM_REL}")

            def new():
                return gru_cuda.sgemm_f32(a, b)

            def lib():
                return torch.matmul(a, b)

            if old is not None:
                o_err = float((old(a, b) - ref).abs().max()) / scale
                if not o_err <= SGEMM_REL:
                    raise AssertionError(f"the tree's sgemm ({tag}): {o_err:.3e} > {SGEMM_REL}")
                t_old = time_ms(lambda: old(a, b), iters=3)
            t_new = time_ms(new, iters=3)
            t_lib = time_ms(lib, iters=3)
            t_new = 0.5 * (t_new + time_ms(new, iters=3))
            if old is not None:
                t_old = 0.5 * (t_old + time_ms(lambda: old(a, b), iters=3))
                res.update(tree_ms=t_old, tree_tflops=flops / t_old / 1e9,
                           tree_max_abs_err_rel=o_err)
        bound, by = f32_bound(flops, 4 * ((1 if shared else 2) * m * k + 2 * k * n + 2 * m * n))
        res.update(ms=t_new, tflops=flops / t_new / 1e9, library_ms=t_lib,
                   library_tflops=flops / t_lib / 1e9, bound_ms=bound, bound_by=by)
        log(f"  sgemm ({tag}) {label}: M={m} K={k} N={n} z=2: {t_new:.3f} ms = "
            f"{res['tflops']:.2f} TFLOP/s; torch.matmul (full float32) {t_lib:.3f} ms = "
            f"{res['library_tflops']:.2f}; bound {bound:.3f} ms ({by}); max|err| / (K max|a| "
            f"max|b|) {err:.2e} (<= {SGEMM_REL})"
            + (f"; the tree's sgemm {res['tree_ms']:.3f} ms = {res['tree_tflops']:.2f} TFLOP/s"
               if old is not None else "") + f" [{card}]")
        rows.append(res)
        del a, b, ref
        torch.cuda.empty_cache()
    return rows


def f32_rows_vs(label, probs, ref, lens, rows):
    """Row by row over the valid frames: max|dprob| <= F32_PROB_ATOL and
    frame argmax agreement >= F32_ARGMAX_MIN."""
    probs, ref = probs[:rows].float().cpu(), ref[:rows].float().cpu()
    lens = [int(n) for n in torch.as_tensor(lens)[:rows].cpu().tolist()]
    worst, least = 0.0, 1.0
    for r, n in enumerate(lens):
        p, q = probs[r, :n], ref[r, :n]
        if not torch.isfinite(p).all():
            raise AssertionError(f"{label}: row {r}: non-finite probabilities")
        worst = max(worst, float((p - q).abs().max()))
        least = min(least, float((p.argmax(-1) == q.argmax(-1)).float().mean()))
    log(f"  {label}: {len(lens)} rows, each row max|dprob| <= {worst:.3e} "
        f"(<= {F32_PROB_ATOL}), argmax agreement >= {least:.5f} (>= {F32_ARGMAX_MIN})")
    if worst > F32_PROB_ATOL or least < F32_ARGMAX_MIN:
        raise AssertionError(f"{label}: outside the stated bounds")
    return {"rows": len(lens), "max_abs_prob_err": worst, "least_row_argmax_agreement": least}


# the float32 wrappers (B1-B9), whose float32 calls on the paths must take
# the persistent design
F32_PERSISTENT = ("gru_bidi_fused", "gru_scan", "gru_scan_bidi", "gru_bwd_scan", "lstm_scan",
                  "lstm_scan_with_cell", "lstm_bwd_scan", "rnn_tanh_scan", "rnn_tanh_bwd_scan")


def f32_launches(before):
    """The float32 launches of B1-B9 since ``before`` (a read of
    :func:`f32_counts`); every launch of those wrappers since then must have
    been a float32 one, and every call (or chain) must have taken the
    persistent design (their ``design_counts``), which is logged."""
    now = f32_counts()
    got = {k: now[k][0] - before[k][0] for k in now}
    if any(now[k][1] - before[k][1] != got[k] for k in now):
        raise AssertionError(f"a bf16 launch on a float32 path: {before} -> {now}")
    designs = {k: {d: now[k][2][d] - before[k][2][d] for d in DESIGNS}
               for k in F32_PERSISTENT if got[k]}
    log(f"    design_counts of the float32 calls of B1-B9: {designs}")
    if any(c["step"] or c["persistent"] != got[k] for k, c in designs.items()):
        raise AssertionError(f"a float32 call of B1-B9 on a path did not take the "
                             f"persistent design: {designs}")
    return got


def f32_counts():
    return {k: (w.dtype_counts["float32"], w.launches, dict(w.design_counts))
            for k, w in kernel_wrappers().items()}


def f32_cohort(card, smodel, launches):
    """12c, cohorts: ``MultiStreamTranscriber(compute_dtype="float32")`` on
    GPUStreamingRNN with its head sharpened (a wrong state moves the
    probabilities by tenths), F32_COHORT streams over one epoch of
    cohort_chunks, against the same cohort on the plain GRU (also float32,
    TF32 off): every step within F32_PROB_ATOL, and every frame whose argmax
    differs a near tie of the plain run (its two largest probabilities within
    F32_TIE). Adds the float32 launches to ``launches``."""
    from danspeech_tpu_torch import MultiStreamTranscriber
    from danspeech_tpu_torch.models import streaming

    model = sharpened(smodel)
    n_layers, n = model.config.rnn_layers, F32_COHORT
    streams = cohort_chunks(n)
    plain = MultiStreamTranscriber(model, n, compute_dtype="float32", rnn_impl="plain")
    ref_probs = []
    record_probs(plain.greedy_decoder, ref_probs)
    run_cohort(plain, streams)
    del plain
    ms = MultiStreamTranscriber(model, n, compute_dtype="float32")
    got_probs = []
    record_probs(ms.greedy_decoder, got_probs)
    before = f32_counts()
    with FlagsSeen([(streaming, "streaming_step_masked")]) as seen:
        finals, step_ms = run_cohort(ms, streams, timed=True)
    got = f32_launches(before)
    want = dict(dict.fromkeys(launches, 0), gru_scan=n_layers * len(streams[0]))
    if got != want or len(finals) != n or not all(isinstance(f, str) for f in finals):
        raise AssertionError(f"float32 cohort S={n}: launches {got} (expected {want}), "
                             f"finals {finals!r}")
    seen.require(f"float32 cohort S={n}")
    for k, v in got.items():
        launches[k] += v
    stats = step_stats("float32 cohort", got_probs, ref_probs)
    flips = ties = 0
    for p, r in zip(got_probs, ref_probs):
        differ = p.argmax(-1) != r.argmax(-1)
        flips += int(differ.sum())
        top2 = np.sort(r[differ], axis=-1)[:, -2:]
        ties += int((top2[:, 1] - top2[:, 0] <= F32_TIE).sum())
    stats.update(argmax_flips=flips, flips_at_near_ties=ties,
                 mean_top_prob=float(np.mean([p.max(-1).mean() for p in got_probs])))
    steady = sorted(step_ms[1:1 + COHORT_STEADY])
    median = steady[len(steady) // 2]
    stats.update(launches=got["gru_scan"], step_ms=step_ms, steady_median_ms=median,
                 streams_in_real_time=n * COHORT_CHUNK / RATE / (median / 1e3))
    log(f"  float32 cohort S={n}, kernel vs plain GRU: {stats['steps']} steps, "
        f"max|dprob|={stats['max_abs_prob_err']:.3e} (<= {F32_PROB_ATOL} at every step), "
        f"{flips} argmax flips over {stats['frames_per_stream']} frames x {n} streams, "
        f"{ties} of them near ties (<= {F32_TIE}); mean top probability "
        f"{stats['mean_top_prob']:.3f}; {got['gru_scan']} float32 gru_scan launches; "
        f"steady step median {median:.2f} ms (min {steady[0]:.2f}, max {steady[-1]:.2f}), "
        f"{stats['streams_in_real_time']:.1f} streams kept in real time [{card}]")
    if stats["max_abs_prob_err"] > F32_PROB_ATOL or ties != flips:
        raise AssertionError(f"float32 cohort S={n}: outside the stated bounds")
    del ms
    torch.cuda.empty_cache()
    return stats


def f32_serve(card, model, waves, launches, per_group):
    """12b, 12g: ``Recognizer(compute_dtype="float32")`` on ``model`` over
    ``waves`` beside bf16 (audio-s/s), the float32 launches of each dispatch
    group held to ``per_group``, every row against the plain recurrence on
    the card and F32_ROWS_ON_CPU rows against the port on the CPU in
    float32 (transcripts equal up to near ties). Adds the launches to
    ``launches``."""
    from danspeech_tpu_torch import Recognizer
    from danspeech_tpu_torch.decode.greedy import GreedyDecoder
    from danspeech_tpu_torch.engine import DanSpeechRecognizer
    from danspeech_tpu_torch.models import deepspeech as ds

    config = model.config
    name = config.model_name
    audio_s = sum(len(w) for w in waves) / RATE
    rec16 = Recognizer(model=model)
    rec = Recognizer(model=model, compute_dtype="float32")
    eng = rec.danspeech_recognizer
    held = [eng._compute_params["fc"].weight.dtype] + [
        w.w_hh.dtype for e in eng._compute_params["rnns"] for w in (e["fwd"], e["bwd"])
        if w is not None]
    if eng.compute_dtype != "float32" or set(held) != {torch.float32}:
        raise AssertionError(f"{name}: the float32 engine holds no float32 weights: {held}")
    log(f"  {name} ({config.rnn_type}), compute_dtype='float32' on CUDA: loaded, "
        "every recurrent and fc weight float32")
    groups = eng._plan_groups(waves)
    rec16.recognize_batch(waves[:4])  # warm-up
    rec.recognize_batch(waves[:4])
    walls = {}
    _, walls["bfloat16"] = timed_batch(rec16, waves)
    before = f32_counts()
    with FlagsSeen([(ds, "forward")]) as seen:
        texts, walls["float32"] = timed_batch(rec, waves)
    got = f32_launches(before)
    want = dict(dict.fromkeys(launches, 0),
                **{k: v * len(groups) for k, v in per_group.items()})
    log(f"  {name} float32 recognize_batch: {len(groups)} dispatch groups, float32 "
        f"launches {got} (expected {per_group} a group)")
    if got != want or len(texts) != len(waves):
        raise AssertionError(f"{name}: the float32 batch did not run every layer on the "
                             f"float32 kernels: {got}, expected {want}")
    seen.require(f"{name} float32 recognize_batch")
    for k, v in got.items():
        launches[k] += v
    _, walls["bfloat16 again"] = timed_batch(rec16, waves)
    serve = {"audio_s": audio_s, "groups": len(groups), "launches": got,
             "float32_audio_s_per_s": audio_s / walls["float32"],
             "bfloat16_audio_s_per_s": [audio_s / walls["bfloat16"],
                                        audio_s / walls["bfloat16 again"]],
             "wall_s": walls}
    log(f"  {name} recognize_batch, {len(waves)} rows, {audio_s:.1f} audio-s: float32 "
        f"{serve['float32_audio_s_per_s']:.1f} audio-s/s; bf16 "
        f"{serve['bfloat16_audio_s_per_s'][0]:.1f}, "
        f"{serve['bfloat16_audio_s_per_s'][1]:.1f} audio-s/s [{card}]")
    # every row against the plain recurrence on the card
    worst = {"max_abs_prob_err": 0.0, "least_row_argmax_agreement": 1.0, "rows": 0}
    for idxs, maxlen in groups:
        staged, lengths = eng._stage_group(waves, idxs, maxlen)
        wave, lens = staged.to("cuda"), torch.from_numpy(lengths).to("cuda")
        probs, out_lens = eng._forward(eng._compute_params, wave, lens)
        ref, _ = eng._forward(eng._compute_params, wave, lens, rnn_impl="plain")
        res = f32_rows_vs(f"{name} float32 group rows={len(idxs)} bucket={maxlen}: kernels "
                          "vs plain recurrence", probs, ref, out_lens, len(idxs))
        worst = {"max_abs_prob_err": max(worst["max_abs_prob_err"], res["max_abs_prob_err"]),
                 "least_row_argmax_agreement": min(worst["least_row_argmax_agreement"],
                                                   res["least_row_argmax_agreement"]),
                 "rows": worst["rows"] + res["rows"]}
        del probs, ref, wave
    serve["vs_plain"] = worst
    # a few rows against the port on the CPU in float32
    cpu = DanSpeechRecognizer(model_name=model, device="cpu", compute_dtype="float32")
    few = seeded_waveforms(np.random.default_rng(12), F32_ROWS_ON_CPU, 1.0, 3.0)
    idxs, maxlen = eng._plan_groups(few)[0]
    staged, lengths = eng._stage_group(few, idxs, maxlen)
    probs, out_lens = eng._forward(eng._compute_params, staged.to("cuda"),
                                   torch.from_numpy(lengths).to("cuda"))
    t0 = time.perf_counter()
    ref, ref_lens = cpu._forward(cpu._compute_params, staged.clone(), torch.from_numpy(lengths))
    log(f"  the port on the CPU, {len(idxs)} rows, float32: {time.perf_counter() - t0:.1f} s")
    serve["vs_cpu"] = f32_rows_vs(f"{name} float32 rows, card vs the port on the CPU", probs,
                                  ref, out_lens, len(idxs))
    greedy = GreedyDecoder(labels=config.labels, blank_index=config.labels.index("_"))
    card_txt, _ = greedy.decode(probs[: len(idxs)].cpu().numpy(),
                                out_lens[: len(idxs)].cpu().numpy())
    cpu_txt, _ = greedy.decode(ref[: len(idxs)].numpy(), ref_lens[: len(idxs)].numpy())
    ties = 0
    for r, (a, b) in enumerate(zip(card_txt, cpu_txt)):
        if a[0] == b[0]:
            continue
        n = int(out_lens[r])
        p, q = probs[r, :n].cpu(), ref[r, :n]
        flips = (p.argmax(-1) != q.argmax(-1)).nonzero().flatten()
        top2 = q[flips].topk(2, dim=-1).values
        if not bool(((top2[:, 0] - top2[:, 1]) <= F32_TIE).all()):
            raise AssertionError(f"{name} row {r}: the card's transcript {a[0]!r} differs "
                                 f"from the CPU's {b[0]!r} beyond near ties")
        ties += 1
    log(f"  {name} transcripts, card vs CPU: {len(card_txt) - ties} of {len(card_txt)} "
        f"equal, {ties} differing only at near ties (<= {F32_TIE})")
    serve["transcripts_equal"] = len(card_txt) - ties
    del rec, rec16, eng, cpu, probs, ref
    torch.cuda.empty_cache()
    return serve


class GcClock:
    """The host time Python's garbage collector takes while it is entered
    (``gc.callbacks``), and its runs by generation."""

    def __init__(self):
        self.s, self.runs, self._t0 = 0.0, [0, 0, 0], None

    def _tick(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.s += time.perf_counter() - self._t0
            self.runs[info["generation"]] += 1
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self._tick)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._tick)


class StepSplit:
    """Splits one train step's wall time: the host time spent in
    ``cuda_build.load`` (building or loading a kernel library; the first
    call in a process opens it), the device time of the recurrent walks by
    CUDA events recorded on the current stream around each call of the
    ``walks`` ((module, attribute) pairs) with the host time inside those
    calls, and the rest of the wall time; beside them the host time in
    Python's garbage collector (:class:`GcClock`)."""

    def __init__(self, walks):
        self.walks, self._saved = walks, []
        self.load_s, self.events, self.walk_host_s = 0.0, [], 0.0
        self.gc = GcClock()

    def __enter__(self):
        from danspeech_tpu_torch.ops import cuda_build

        load = cuda_build.load

        def timed_load(name, _load=load):
            t0 = time.perf_counter()
            try:
                return _load(name)
            finally:
                self.load_s += time.perf_counter() - t0

        self._saved.append((cuda_build, "load", load))
        cuda_build.load = timed_load
        for mod, name in self.walks:
            fn = getattr(mod, name)

            def timed(*a, _fn=fn, **k):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0 = time.perf_counter()
                start.record()
                try:
                    return _fn(*a, **k)
                finally:
                    end.record()
                    self.walk_host_s += time.perf_counter() - t0
                    self.events.append((start, end))

            timed.__dict__ = fn.__dict__  # a wrapper's counts stay where they are kept
            self._saved.append((mod, name, fn))
            setattr(mod, name, timed)
        self.gc.__enter__()
        return self

    def __exit__(self, *exc):
        self.gc.__exit__()
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def result(self, wall_s):
        """The split of a step of ``wall_s`` seconds, after a synchronize."""
        walks_ms = sum(s.elapsed_time(e) for s, e in self.events)
        return {"wall_s": wall_s, "load_s": self.load_s,
                "walk_calls": len(self.events), "walks_device_ms": walks_ms,
                "walks_host_ms": self.walk_host_s * 1e3,
                "gc_s": self.gc.s, "gc_runs_by_generation": self.gc.runs,
                "rest_s": wall_s - self.load_s - walks_ms / 1e3}


def f32_walks(config):
    """The (module, attribute) pairs of the recurrent walks a float32 train
    step of ``config`` calls: its layers' forward and backward entries."""
    from danspeech_tpu_torch.ops import gru_cuda, lstm_cuda, rnn_tanh_cuda

    return {"gru": [(gru_cuda, "gru_bidi_fused"), (gru_cuda, "gru_bwd_scan_pair")],
            "lstm": [(lstm_cuda, "lstm_scan_pair"), (lstm_cuda, "lstm_bwd_scan_pair")],
            "rnn": [(rnn_tanh_cuda, "rnn_tanh_scan_pair"),
                    (rnn_tanh_cuda, "rnn_tanh_bwd_scan_pair")]}[config.rnn_type]


def f32_train(card, config, seed, launches, per_step, checked=True):
    """12e, 12g: two ``mixed_precision=False`` train steps of ``config`` at
    B = TRAIN_BATCH (loss, wall time, the float32 launches held to
    ``per_step``, peak memory), each split by :class:`StepSplit`, then the
    gradients of an 8-row batch through the kernels against the plain path
    within F32_GRAD_REL. Adds the launches to ``launches``. With
    ``checked=False`` (``--f32-train``) the launches, their designs and the
    flags are not held to anything."""
    from danspeech_tpu_torch import train as tr
    from danspeech_tpu_torch.models import deepspeech as ds
    from danspeech_tpu_torch.train import step as tstep

    name = config.model_name
    optimizer = tr.make_optimizer(TRAIN_LR)
    state = tr.init_train_state(config, optimizer, seed=seed)
    batch, t_audio = train_batch(np.random.default_rng(8 + seed), config, TRAIN_BATCH)
    step_fn = tr.make_wave_train_step(config, optimizer, augment=None,
                                      mixed_precision=False, remat=True)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    want = dict(dict.fromkeys(launches, 0), **per_step)
    for k in range(2):
        before = f32_counts()
        with FlagsSeen([(ds, "forward"), (tstep, "_update")]) as seen, \
                StepSplit(f32_walks(config)) as split:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step_fn(state, *batch, None)
            loss = float(loss)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        parts = split.result(wall)
        now = f32_counts()
        got = f32_launches(before) if checked else {
            kernel: now[kernel][0] - before[kernel][0] for kernel in now}
        if not np.isfinite(loss) or (checked and got != want):
            raise AssertionError(f"{name} float32 train step {k + 1}: loss {loss}, "
                                 f"launches {got}, expected {want}")
        if checked:
            seen.require(f"{name} float32 train step {k + 1}")
        for kernel, v in got.items():
            launches[kernel] += v
        steps.append({"loss": loss, "wall_s": wall, "audio_s_per_step_s": t_audio / wall,
                      "launches": got, "split": parts})
        log(f"  {name} float32 train step {k + 1} (B={TRAIN_BATCH}, remat): loss "
            f"{loss:.4f}, {wall:.3f} s, {t_audio / wall:.1f} audio-s per step-second, "
            f"launches {got} [{card}]")
        log(f"    split: building or loading libraries {parts['load_s'] * 1e3:.3f} ms; "
            f"the walks' {parts['walk_calls']} calls {parts['walks_device_ms']:.3f} ms on the "
            f"device by CUDA events, {parts['walks_host_ms']:.3f} ms on the host inside them; "
            f"the rest {parts['rest_s'] * 1e3:.3f} ms; {parts['gc_s'] * 1e3:.3f} ms in the "
            f"garbage collector (runs by generation {parts['gc_runs_by_generation']})")
    peak = torch.cuda.max_memory_allocated()
    log(f"  {name}: peak device memory over the float32 steps: {peak / 2**30:.2f} GiB")
    del state, step_fn
    torch.cuda.empty_cache()
    small, _ = train_batch(np.random.default_rng(9 + seed), config, 8)
    grads = {}
    for impl in ("auto", "plain"):
        st = tr.init_train_state(config, optimizer, seed=seed)
        fn = tr.make_wave_train_step(config, optimizer, augment=None,
                                     mixed_precision=False, remat=True, rnn_impl=impl)
        st, loss = fn(st, *small)
        grads[impl] = (grad_groups(st.params), float(loss))
        del st, fn
        torch.cuda.empty_cache()
    rel = {g: float((grads["auto"][0][g] - ref).norm() / ref.norm().clamp(min=1e-30))
           for g, ref in grads["plain"][0].items()}
    log(f"  {name} float32 gradients of an 8-row batch, kernels vs plain path, relative "
        "L2 by group: " + ", ".join(f"{g} {e:.3e}" for g, e in rel.items())
        + f" (limit {F32_GRAD_REL}); loss {grads['auto'][1]:.6f} vs {grads['plain'][1]:.6f}")
    if not all(e <= F32_GRAD_REL for e in rel.values()):
        raise AssertionError(f"{name}: float32 gradients outside the stated limit")
    return {"steps": steps, "peak_memory_bytes": peak, "audio_s": t_audio,
            "batch_rows": TRAIN_BATCH, "grad_rel_l2": rel, "limit": F32_GRAD_REL}


def phase_float32(card):
    """12: the float32 modes on the card, in a process that allows TF32:
    (a) the entries of B1-B9 against their plain versions, (b) the flagship
    served, (c) GPUStreamingRNN batch, streaming and a cohort, (d) the
    flagship's long form, (e) mixed_precision=False train steps, (f, g)
    LSTM5x800 and Tanh5x800 loaded, served and trained in float32."""
    from danspeech_tpu_torch import Recognizer
    from danspeech_tpu_torch.models import DeepSpeechConfig, DeepSpeechModel
    from danspeech_tpu_torch.models import deepspeech as ds
    from danspeech_tpu_torch.models import streaming
    from danspeech_tpu_torch.ops import gru_cuda, precision
    from danspeech_tpu_torch.parallel import make_mesh
    from danspeech_tpu_torch.parallel import time_shard
    from danspeech_tpu_torch.parallel.time_shard import long_form_probs, pad_time_for_mesh

    t_phase = time.perf_counter()
    saved = f32_flags()
    set_f32_flags(USER_FLAGS)
    out = {"card": card}
    launches = dict.fromkeys(kernel_wrappers(), 0)
    try:
        inside, outside = tf32_probe(lambda: precision.full_float32("cuda"))
        log(f"  TF32 probe, max|err| / max|ref| against float64: inside the float32 "
            f"scope {inside}, outside it (TF32 allowed) {outside}")
        if max(inside.values()) > 1e-5 or outside["matmul"] < 1e-5:
            raise AssertionError("the float32 scope does not turn TF32 off, or the probe "
                                 "does not see TF32")
        if f32_flags() != USER_FLAGS:
            raise AssertionError(f"the scope left the flags at {f32_flags()}")
        out["tf32_probe"] = {"inside": inside, "outside": outside}

        t0 = time.perf_counter()
        out["kernels"] = {**phase_f32_kernels(card), **phase_f32_rnn_kernels()}
        out["gemm"] = phase_f32_gemm(card)
        out["kernels_s"] = time.perf_counter() - t0
        gemm_before = gru_cuda.sgemm_f32.launches

        # 12b: the flagship served in float32, beside bf16
        config = DeepSpeechConfig(**FLAGSHIP)
        model = DeepSpeechModel.init_random(config, seed=0)
        waves = seeded_waveforms(np.random.default_rng(0), 128)  # phase 4's first batch
        out["serve"] = f32_serve(card, model, waves, launches,
                                 {"gru_bidi_fused": config.rnn_layers})
        torch.cuda.empty_cache()

        # 12c: GPUStreamingRNN in float32: a batch, then streaming chunk by chunk
        sconfig = DeepSpeechConfig(**GPU_STREAMING)
        smodel = DeepSpeechModel.init_random(sconfig, seed=2)
        srec = Recognizer(model=smodel, compute_dtype="float32")
        seng = srec.danspeech_recognizer
        swaves = seeded_waveforms(np.random.default_rng(5), F32_STREAM_ROWS)
        sgroups = seng._plan_groups(swaves)
        before = f32_counts()
        with FlagsSeen([(ds, "forward")]) as seen, GcClock() as collected:
            texts, wall = timed_batch(srec, swaves)
        got = f32_launches(before)
        if got["gru_scan"] != sconfig.rnn_layers * len(sgroups) or sum(got.values()) != got["gru_scan"]:
            raise AssertionError(f"float32 uni batch: launches {got}")
        seen.require("float32 uni recognize_batch")
        for k, v in got.items():
            launches[k] += v
        s_audio = sum(len(w) for w in swaves) / RATE
        idxs, maxlen = sgroups[0]
        staged, lengths = seng._stage_group(swaves, idxs, maxlen)
        wave, lens = staged.to("cuda"), torch.from_numpy(lengths).to("cuda")
        probs, out_lens = seng._forward(seng._compute_params, wave, lens)
        ref, _ = seng._forward(seng._compute_params, wave, lens, rnn_impl="plain")
        stream = {"batch_audio_s_per_s": s_audio / wall, "batch_launches": got,
                  "batch_gc_s": collected.s, "batch_gc_runs_by_generation": collected.runs,
                  "batch_vs_plain": f32_rows_vs(
                      f"float32 uni group rows={len(idxs)}: kernels vs plain GRU", probs,
                      ref, out_lens, len(idxs))}
        log(f"  float32 GPUStreamingRNN recognize_batch: {F32_STREAM_ROWS} rows, "
            f"{s_audio:.1f} audio-s in {wall:.3f} s = {s_audio / wall:.1f} audio-s/s, "
            f"{collected.s * 1e3:.3f} ms of it in the garbage collector (runs by generation "
            f"{collected.runs}) [{card}]")
        del probs, ref, wave
        srec.enable_real_time_streaming(smodel, string_parts=True)
        calls, _ = record_calls(seng)
        audio = (np.random.default_rng(6).normal(size=8 * RATE) * 3000.0).astype(np.float32)
        plan = accumulate(audio, sconfig.context)
        before = f32_counts()
        chunk_ms = []
        with FlagsSeen([(streaming, "streaming_step_masked")]) as seen:
            for chunk, first, last in plan:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                seng.streaming_transcribe(chunk, is_last=last, is_first=first)
                torch.cuda.synchronize()
                chunk_ms.append((time.perf_counter() - t0) * 1e3)
        got = f32_launches(before)
        steps = frame_steps(calls, sconfig.audio_conf)
        if got["gru_scan"] != sconfig.rnn_layers * len(steps) or sum(got.values()) != got["gru_scan"]:
            raise AssertionError(f"float32 streaming: launches {got}, {len(steps)} steps")
        seen.require("float32 streaming_transcribe")
        for k, v in got.items():
            launches[k] += v
        with seng._precision():
            stream["chunks_vs_plain"] = check_stream_chunks(
                "float32 streaming_transcribe", seng, steps)
        if stream["chunks_vs_plain"]["worst_chunk_max_abs_prob_err"] > F32_PROB_ATOL:
            raise AssertionError("float32 streaming chunks outside F32_PROB_ATOL")
        steady = sorted(chunk_ms[1:-1])
        stream.update(chunks=len(plan), steps=len(steps), launches=got,
                      steady_chunk_ms={"min": steady[0], "median": steady[len(steady) // 2],
                                       "max": steady[-1]})
        log(f"  float32 streaming_transcribe: {len(plan)} chunks, {len(steps)} with frames, "
            f"{got['gru_scan']} float32 gru_scan launches; steady chunk min "
            f"{steady[0]:.2f} ms, median {steady[len(steady) // 2]:.2f} ms [{card}]")
        seng.reset_streaming_params()
        del srec, seng
        torch.cuda.empty_cache()
        stream["cohort"] = f32_cohort(card, smodel, launches)
        out["stream"] = stream
        del smodel
        torch.cuda.empty_cache()

        # 12d: one 60 s long form of the flagship in float32 (B2)
        mesh = make_mesh()
        lrec = Recognizer(model=model, compute_dtype="float32")
        params = lrec.danspeech_recognizer._compute_params
        wave = long_wave()
        before = f32_counts()
        with FlagsSeen([(time_shard, "transcribe_long_form")]) as seen:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lrec.recognize_long_form(wave, mesh=mesh)
            wall = time.perf_counter() - t0
        got = f32_launches(before)
        if got != dict(dict.fromkeys(launches, 0), gru_scan_bidi=config.rnn_layers):
            raise AssertionError(f"float32 long form: launches {got}")
        seen.require("float32 recognize_long_form")
        for k, v in got.items():
            launches[k] += v
        with precision.full_float32("cuda"):
            probs, lens = long_form_probs(model, wave, mesh, params=params)
            spect, frames = padded_spect(model, [wave], mesh.device)
            with torch.inference_mode():
                ref, _ = ds.forward(params, config, pad_time_for_mesh(spect, 1), frames,
                                    rnn_impl="plain")
        out["long_form"] = {"wall_s": wall, "audio_s_per_s": LONG_FORM_S / wall,
                            "frames": int(lens[0]), "launches": got,
                            "vs_plain": f32_rows_vs("float32 long form (60 s) vs forward on "
                                                    "the plain GRU", probs, ref, lens, 1)}
        log(f"  float32 recognize_long_form, flagship: {LONG_FORM_S:.0f} s (T' = "
            f"{int(lens[0])}) in {wall:.3f} s, {got['gru_scan_bidi']} float32 gru_scan_bidi "
            f"[{card}]")
        import torch.distributed as dist

        dist.destroy_process_group()
        del lrec, params, probs, ref, spect
        torch.cuda.empty_cache()

        # 12e: mixed_precision=False train steps of the flagship at B = 32
        out["train"] = f32_train(card, config, 0, launches,
                                 {"gru_bidi_fused": 2 * config.rnn_layers,
                                  "gru_bwd_scan": config.rnn_layers})
        del model
        torch.cuda.empty_cache()

        # 12f, 12g: LSTM5x800 and Tanh5x800 loaded, served and trained in float32
        for cfg in (LSTM5X800, TANH5X800):
            rconfig = DeepSpeechConfig(**cfg)
            layers = rconfig.rnn_layers
            if rconfig.rnn_type == "lstm":
                # a layer's two chains are one float32 launch; with remat the
                # first forward keeps nothing (B5), the recomputed one the
                # cell streams (B6), and one launch walks both chains (B7)
                serve_want = {"lstm_scan": layers}
                step_want = {"lstm_scan": layers, "lstm_scan_with_cell": layers,
                             "lstm_bwd_scan": layers}
            else:
                serve_want = {"rnn_tanh_scan": layers}
                step_want = {"rnn_tanh_scan": 2 * layers, "rnn_tanh_bwd_scan": layers}
            rmodel = DeepSpeechModel.init_random(rconfig, seed=12)
            out[rconfig.model_name] = {
                "serve": f32_serve(card, rmodel, waves, launches, serve_want),
                "train": f32_train(card, rconfig, 12, launches, step_want)}
            del rmodel
            torch.cuda.empty_cache()
    finally:
        set_f32_flags(saved)
    out["launches"] = launches
    # the GEMM is launched inside the float32 entries of B3, B4 and B7 (one
    # launch a call of their C entries), which count it
    out["gemm_launches"] = gru_cuda.sgemm_f32.launches - gemm_before
    out["wall_s"] = time.perf_counter() - t_phase
    for name, n in {**launches, "sgemm": out["gemm_launches"]}.items():
        if not n:
            raise AssertionError(f"{name}'s float32 variant was launched no time on the "
                                 "float32 paths")
    log(f"  phase 12: {out['wall_s']:.1f} s; float32 launches on its paths {launches}, "
        f"the GEMM {out['gemm_launches']} [{card}]")
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


# the sums gru_f32.cu's persistent walk keeps when built with -DPS_PROFILE:
# a step is barrier + the first chunks' copies + (per chunk) the wait and the
# block's barrier + the FFMAs (and thread 0's copies of the next chunk) +
# the partial sums + the epilogue
F32_PHASE_CLOCKS = {1: "grid barrier", 2: "copies of the first chunks",
                    5: "waiting for a chunk (and the block's barrier)",
                    10: "FFMAs (and thread 0's copies of the next chunk)",
                    8: "partial sums to shared memory", 3: "epilogue", 0: "other"}


def phase_clocks(card):
    """Builds the seven persistent kernels' sources, ``gru_f32``, ``lstm_f32`` and
    ``rnn_tanh_f32`` with -DPS_PROFILE into a build directory of their own, runs the persistent
    kernels once at the flagship, the 2000-wide, the streaming, the bidi batch and the LSTM and
    tanh-RNN serving and training shapes, and prints the clocks that thread
    0 of block 0 spent per step in each part (the instrumented build is a
    little slower than the plain one). The tanh pairs run once more with
    wider slices on fewer blocks, the plan's knob, to compare within the
    call; the float32 GRU forward walk runs at B1's streaming and batch
    shapes, B2's and B3's flagship layer, its backward walk (B4) as the
    flagship's training pair, the float32 LSTM forward walk (B5, B6) as
    LSTM5x800's serving and training pairs, its backward walk (B7) as
    LSTM5x800's training pair, the float32 tanh-RNN forward walk (B8) as
    Tanh5x800's serving pair and its backward walk (B9) as Tanh5x800's
    training pair."""
    import ctypes

    from danspeech_tpu_torch.ops import (cuda_build, gru_cuda, lstm_cuda, persist_plan,
                                         rnn_tanh_cuda, walks)

    cuda_build.NVCC_FLAGS.append("-DPS_PROFILE")
    cuda_build.BUILD_DIR = os.path.join(cuda_build.BUILD_DIR, "profile")
    cuda_build.build("gru_bidi_fused", "gru_bwd", "gru_scan", "lstm_scan", "lstm_bwd",
                     "rnn_tanh_scan", "rnn_tanh_bwd", "gru_f32", "lstm_f32", "rnn_tanh_f32")

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

    def report_f32(tag, fn, steps, lib="gru_f32"):
        fn()
        torch.cuda.synchronize()
        read(lib)
        ms = time_ms(fn, iters=1, warmup=0)
        sums = read(lib)
        step = sum(sums)
        log(f"  {tag}: {ms:.3f} ms a call, {step / steps:.0f} clocks a step [{card}]")
        for i, name in F32_PHASE_CLOCKS.items():
            log(f"    {name:48s} {sums[i] / steps:9.0f} clocks a step "
                f"{100 * sums[i] / max(step, 1):5.1f}%")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t = 401
    # the float32 GRU forward walk (persistent): B1 at the streaming chunk and
    # the uni batch, B2 at the bidi batch layer, B3 at the flagship's layer 0
    for label, tt, lengths in (("streaming step", STREAM_T, [STREAM_VALID]),
                               ("uni batch layer", t, [t] + [1 + (7 * i) % t
                                                             for i in range(127)])):
        args = scan_inputs(gen, tt, lengths, 2000, carried=True, dtype=torch.float32)
        report_f32(f"gru_scan float32 {label} T={tt} B={len(lengths)} H=2000",
                   lambda: gru_cuda.gru_scan(*args, design="persistent"), max(lengths))
        del args
    flag = np.random.default_rng(2016).integers(1, 402, size=128)
    flag[0] = 401
    fwd = scan_inputs(gen, t, flag.tolist(), 1200, carried=True, dtype=torch.float32)
    bwd = scan_inputs(gen, t, flag.tolist(), 1200, carried=True, dtype=torch.float32)
    report_f32(f"gru_scan_bidi float32 T={t} B=128 H=1200",
               lambda: gru_cuda.gru_scan_bidi(fwd[0], bwd[0], fwd[1], fwd[2], bwd[2], fwd[3],
                                              bwd[3], fwd[4], bwd[4], fwd[5], bwd[5],
                                              design="persistent"), t)
    del fwd, bwd
    args = gru_layer_inputs(gen, t, 128, 2016, 1200, flag.tolist(), dtype=torch.float32)
    report_f32(f"gru_bidi_fused float32 T={t} B=128 D=2016 H=1200",
               lambda: gru_cuda.gru_bidi_fused(*args, design="persistent"), t)
    del args
    # the float32 backward walk (persistent) as the pair of the flagship's
    # training layer (T + 1 steps: the last pass finishes the carry); the
    # float32 LSTM forward walk as the pairs of LSTM5x800's training and
    # serving layers
    train32 = np.random.default_rng(1201).integers(1, 402, size=32)
    train32[0] = 401
    wa = bwd_inputs(gen, t, train32.tolist(), 1200, dtype=torch.float32)
    wb = bwd_inputs(gen, t, train32.tolist(), 1200, lens=wa[3], dtype=torch.float32)
    report_f32(f"gru_bwd_scan_pair float32 T={t} B=32 H=1200",
               lambda: gru_cuda.gru_bwd_scan_pair(wa, wb, True, False, design="persistent"),
               t + 1)
    del wa, wb
    for b, seed in ((32, 801), (128, 800)):
        lengths = np.random.default_rng(seed).integers(1, 402, size=b)
        lengths[0] = 401
        lens = torch.tensor(lengths.tolist(), dtype=torch.int32, device="cuda")
        la = f32_rnn_operands("lstm_scan", gen, t, lengths.tolist(), 800, lens)
        lb = f32_rnn_operands("lstm_scan", gen, t, lengths.tolist(), 800, lens)
        report_f32(f"lstm_scan_pair float32 T={t} B={b} H=800{' with c_seq' if b == 32 else ''}",
                   lambda: lstm_cuda.lstm_scan_pair(la, lb, False, True, with_cell=b == 32,
                                                    design="persistent"), t, lib="lstm_f32")
        del la, lb
        # the float32 LSTM backward walk (B7) and tanh-RNN backward walk (B9)
        # as the pairs of the training layers (T + 1 steps: the last pass
        # finishes the carry), the float32 tanh-RNN forward walk (B8) as the
        # pair of Tanh5x800's serving layer
        if b == 32:
            wa = f32_rnn_operands("lstm_bwd_scan", gen, t, lengths.tolist(), 800, lens)
            wb = f32_rnn_operands("lstm_bwd_scan", gen, t, lengths.tolist(), 800, lens)
            report_f32(f"lstm_bwd_scan_pair float32 T={t} B={b} H=800",
                       lambda: lstm_cuda.lstm_bwd_scan_pair(wa, wb, True, False,
                                                            design="persistent"),
                       t + 1, lib="lstm_f32")
            del wa, wb
            wa = f32_rnn_operands("rnn_tanh_bwd_scan", gen, t, lengths.tolist(), 800, lens)
            wb = f32_rnn_operands("rnn_tanh_bwd_scan", gen, t, lengths.tolist(), 800, lens)
            report_f32(f"rnn_tanh_bwd_scan_pair float32 T={t} B={b} H=800",
                       lambda: rnn_tanh_cuda.rnn_tanh_bwd_scan_pair(wa, wb, True, False,
                                                                    design="persistent"),
                       t + 1, lib="rnn_tanh_f32")
            del wa, wb
        else:
            ta = f32_rnn_operands("rnn_tanh_scan", gen, t, lengths.tolist(), 800, lens)
            tb = f32_rnn_operands("rnn_tanh_scan", gen, t, lengths.tolist(), 800, lens)
            report_f32(f"rnn_tanh_scan_pair float32 T={t} B={b} H=800",
                       lambda: rnn_tanh_cuda.rnn_tanh_scan_pair(ta, tb, False, True,
                                                                design="persistent"),
                       t, lib="rnn_tanh_f32")
            del ta, tb
    torch.cuda.empty_cache()
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
    _, smem_optin = walks.device_info(torch.device("cuda", torch.cuda.current_device()))
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


# B5 at Mozilla DeepSpeech's one LSTM (H = 2048): no persistent plan fits, so
# one chain walks one launch a step; dispatch groups of 2-20 s utterances
B5_H2048 = (1000, 2048, (16, 32, 64, 128))
B5_H2048_TITLE = "phase 3c: B5 (lstm_scan) at H = 2048, T = 1000, one chain, step design"


def phase_b5_h2048(card):
    """B5 (``lstm_scan``) at H = 2048, T = 1000 and B = 16, 32, 64 and 128,
    each batch with ragged lengths (the longest T, one of 1), one chain as
    the served path calls it (``design=None``): the plan must be the step
    design, the result is held to the plain version (GRU_ATOL), the step
    kernel's launches counted one a step (``lstm_step_launches``), timed by
    CUDA events beside cuDNN's ``nn.LSTM`` in bf16, one direction; µs a
    step over the T launched (``engine.STEP_TWO_BLOCKS`` is the ratio of B =
    128's to B = 64's)."""
    from danspeech_tpu_torch.ops import lstm_cuda, persist_plan, walks

    t, h, batches = B5_H2048
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2048)
    rows = []
    for b in batches:
        lengths = np.random.default_rng(2048 + b).integers(1, t + 1, size=b)
        lengths[0], lengths[1] = t, 1
        args = lstm_inputs(gen, t, lengths.tolist(), h)
        planned = persist_plan.plan_lstm_forward(h, b, 1, *walks.device_info(args[1].device))
        if planned.design != "step":
            raise AssertionError(f"B5 H={h} B={b}: planned {planned}")
        ref = lstm_cuda.lstm_scan_plain(*args)
        before = lstm_cuda.lstm_step_launches.design_counts["step"]
        got = lstm_cuda.lstm_scan(*args)
        torch.cuda.synchronize()
        launched = lstm_cuda.lstm_step_launches.design_counts["step"] - before
        if launched != t:
            raise AssertionError(f"B5 H={h} B={b}: {launched} step launches counted, not {t}")
        errs, _ = compare_outputs(f"B5 H={h} B={b}", ("out", "h_last", "c_last"), got, ref,
                                  GRU_ATOL)
        ms = time_ms(lambda: lstm_cuda.lstm_scan(*args), iters=3)
        res = {"label": f"H={h} B={b}", "t": t, "b": b, "errs": errs, "kernel_ms": ms,
               "us_a_step": 1e3 * ms / t,
               "library_ms": cudnn_rnn_ms(torch.nn.LSTM(h, h), gen, t, b, h, backward=False)}
        log(f"  B5 H={h} T={t} B={b}, one chain, step design: {ms:.3f} ms = "
            f"{res['us_a_step']:.2f} us a step; cuDNN nn.LSTM bf16 one direction "
            f"{res['library_ms']:.3f} ms; max|err| "
            + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()) + f" [{card}]")
        rows.append(res)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true",
                    help="run phases 1-3 only (build and kernel checks)")
    ap.add_argument("--only", type=int, choices=(8, 9, 10, 11, 12),
                    help="run phases 1, 2 and this one only (build, then 8: serving "
                         "with an LM, 9: the rest of the single-GPU surface, 10: "
                         "parallelism, 11: the gallery, or 12: float32)")
    ap.add_argument("--phase-clocks", action="store_true",
                    help="instead of the phases: build the persistent kernels with "
                         "-DPS_PROFILE and print where a step spends its clocks")
    ap.add_argument("--sgemm-against", metavar="TREE",
                    help="run phases 1, 2 and only phase 12a's float32 GEMM, with the GEMM "
                         "of TREE's danspeech_tpu_torch/csrc/sgemm.cuh (another commit's "
                         "tree) built and timed in turns beside this tree's; not a smoke "
                         "check: it prints no device line")
    ap.add_argument("--f32-train", action="store_true",
                    help="run phases 1, 2 and only phase 12g's float32 train steps of "
                         "LSTM5x800 and Tanh5x800, each step split (library loads, the "
                         "walks, the rest, the garbage collector), their launches, designs "
                         "and flags not held to anything, so that an older tree's steps "
                         "split the same way (ROADMAP P15); not a smoke check: it prints "
                         "no device line")
    ap.add_argument("--lookahead", action="store_true",
                    help="run phases 1, 2 and 11c only (build, then the lookahead "
                         "stencil alone against its plain version and F.conv1d)")
    ap.add_argument("--b5-h1024", action="store_true",
                    help="run phases 1, 2 and 3b only (build, then B5 at H = 1024, T = "
                         "1000, B = 16, 32 and 128 against its plain version and cuDNN)")
    ap.add_argument("--b5-h2048", action="store_true",
                    help="run phases 1, 2 and 3c only (build, then B5's step design at "
                         "H = 2048, T = 1000, B = 16, 32, 64 and 128, one chain, against "
                         "its plain version and cuDNN)")
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
        entry = ""  # the function ptxas reports on
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else ""
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {entry}: {line.strip()}")

    if args.sgemm_against:
        print(json.dumps({"sgemm": phase_f32_gemm(card, against=args.sgemm_against),
                          "against": args.sgemm_against, "card": card}))
        return 0

    if args.f32_train:
        from danspeech_tpu_torch.models import DeepSpeechConfig

        saved = f32_flags()
        set_f32_flags(USER_FLAGS)
        try:
            runs = {}
            for cfg in (LSTM5X800, TANH5X800):
                rconfig = DeepSpeechConfig(**cfg)
                runs[rconfig.model_name] = f32_train(
                    card, rconfig, 12, dict.fromkeys(kernel_wrappers(), 0), {},
                    checked=False)
                torch.cuda.empty_cache()
        finally:
            set_f32_flags(saved)
        print(json.dumps({"f32_train": runs, "card": card}))
        return 0

    if args.lookahead:
        log(LOOKAHEAD_TITLE)
        print(json.dumps({"lookahead": phase_lookahead(card), "card": card}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.b5_h1024:
        log(B5_H1024_TITLE)
        saved = f32_flags()
        set_f32_flags(F32_FLAGS)
        try:
            print(json.dumps({"b5_h1024": phase_b5_h1024(card), "card": card}))
        finally:
            set_f32_flags(saved)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.b5_h2048:
        log(B5_H2048_TITLE)
        saved = f32_flags()
        set_f32_flags(F32_FLAGS)
        try:
            print(json.dumps({"b5_h2048": phase_b5_h2048(card), "card": card}))
        finally:
            set_f32_flags(saved)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.only:
        if args.only == 8:
            log("phase 8: serving with a language model (host, device and auto beams)")
            print(json.dumps({"lm_serving": phase_lm(card), "card": card}))
        elif args.only == 9:
            log("phase 9: the rest of the single-GPU surface (.pth, mu-law, "
                "multi-stream, listen)")
            print(json.dumps({"surface": phase_surface(card), "card": card}))
        elif args.only == 10:
            log("phase 10: parallelism (mesh, data parallelism, long form, sharded "
                "beam, tensor and pipeline parallelism)")
            print(json.dumps({"parallel": phase_parallel(card), "card": card}))
        elif args.only == 11:
            log(GALLERY_TITLE)
            print(json.dumps({"gallery": phase_gallery(card), "card": card}))
            log(LOOKAHEAD_TITLE)
            print(json.dumps({"lookahead": phase_lookahead(card), "card": card}))
        else:
            log(FLOAT32_TITLE)
            print(json.dumps({"float32": phase_float32(card), "card": card}))
        log(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # phase 3, the plain versions in full float32; the process's flags come
    # back after it, so that phases 4-12 run as a user's process does
    log("phase 3: the grid barrier alone, then kernels vs plain versions")
    saved = f32_flags()
    set_f32_flags(F32_FLAGS)
    try:
        barrier = phase_barrier()
        gru_checks = phase_kernels()
        scan_checks = phase_scan_kernels()
        bidi_checks = phase_scan_bidi_kernels()
        bwd_checks = phase_bwd_kernels()
        routes = phase_gru_layer_routes()
        rnn_type_checks = phase_rnn_type_kernels()
        log(B5_H1024_TITLE)
        b5_h1024 = phase_b5_h1024(card)
        log(B5_H2048_TITLE)
        b5_h2048 = phase_b5_h2048(card)
    finally:
        set_f32_flags(saved)
    log(f"  the float32 flags (matmul precision, cuDNN TF32) after phase 3: {f32_flags()}")

    launches = {}  # per kernel, summed over the main paths of phases 4-11
    chains = {}  # the chains those launches walked, for the kernels launched as pairs
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
        log("phase 9: the rest of the single-GPU surface (.pth, mu-law, multi-stream, "
            "listen)")
        surface = phase_surface(card)
        log("phase 10: parallelism (mesh, data parallelism, long form, sharded beam, "
            "tensor and pipeline parallelism)")
        parallel = phase_parallel(card)
        log(GALLERY_TITLE)
        gallery = phase_gallery(card)
        log(LOOKAHEAD_TITLE)
        lookahead = phase_lookahead(card)
        log(FLOAT32_TITLE)
        float32 = phase_float32(card)
        chains = {**lstm_run["chains"], **tanh_run["chains"]}
        launches = {
            "gru_bidi_fused": served["launches"] + streamed["bidi_launches"]
            + trained["launches"]["gru_bidi_fused"] + lm_run["launches"]["gru_bidi_fused"]
            + surface["launches"]["gru_bidi_fused"] + parallel["launches"]["gru_bidi_fused"],
            "gru_scan": streamed["scan_launches"] + trained["launches"]["gru_scan"]
            + lm_run["launches"]["gru_scan"] + surface["launches"]["gru_scan"]
            + parallel["launches"]["gru_scan"],
            "gru_scan_bidi": routes["launches"] + parallel["launches"]["gru_scan_bidi"],
            "gru_bwd_scan": trained["launches"]["gru_bwd_scan"],
        }
        for name in ("lstm_scan", "lstm_scan_with_cell", "lstm_bwd_scan"):
            launches[name] = lstm_run["launches"][name]
        for name in ("rnn_tanh_scan", "rnn_tanh_bwd_scan"):
            launches[name] = tanh_run["launches"][name]
        for name, n in gallery["launches"].items():
            launches[name] += n
        for name, n in launches.items():
            # B6's launches on the main paths are lstm_persist_kernel's,
            # counted on lstm_scan; the training steps of phase 7 need them
            if not n and name != "lstm_scan_with_cell":
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
            "card": card,
            "shapes": checks,
        }

    def with_f32(e, main_label):
        """The entry ``e`` with a ``float32`` object: its float32 variant at
        the main shape of phase 12a, launched on phase 12's paths."""
        name = e["name"]
        if args.kernels:
            return e
        checks = float32["kernels"][name]
        main = next(c for c in checks if c["label"] == main_label)
        source, library = F32_SOURCES[name]
        e["float32"] = {
            **{k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                    "kernel_ms", "kernel_us_a_step", "launches_profiled")},
            **{k: main[k] for k in (
                "us_a_step", "walk_ms", "pair_ms_per_chain", "pair_us_a_step",
                "step_design_pair_ms_per_chain", "step_design_pair_us_a_step", "pair_plan",
                "step_design_ms", "step_design_walk_ms", "step_design_us_a_step",
                "step_design_kernel_ms", "step_design_kernel_us_a_step",
                "step_design_launches_profiled", "resident_share", "plan", "split")
               if k in main},
            "source": f"danspeech_tpu_torch/csrc/{source}.cu",
            "design": main.get("design", "step"),
            "launches": float32["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in checks), "atol": F32_ATOL,
            "library": f"one cuDNN {library} call in float32, TF32 off",
            "shape": main["label"], "shapes": checks,
        }
        return e

    next(c for c in gru_checks if c["shape"]["D"] == 2016)["label"] = "flagship layer 0"
    kernels = [
        with_f32(entry("gru_bidi_fused", gru_checks, "flagship layer 0"), "flagship layer 0"),
        with_f32(entry("gru_scan", scan_checks, "uni batch layer"), "uni batch layer"),
        with_f32(entry("gru_scan_bidi", bidi_checks, "bidi batch layer"), "bidi batch layer"),
        with_f32(entry("gru_bwd_scan", bwd_checks, "flagship layer"), "flagship layer"),
        with_f32(entry("lstm_scan", rnn_type_checks["lstm_scan"], "serve layer"),
                 "serve layer"),
        with_f32(entry("lstm_scan_with_cell", rnn_type_checks["lstm_scan_with_cell"],
                       "train layer"), "train layer"),
        with_f32(dict(entry("lstm_bwd_scan", rnn_type_checks["lstm_bwd_scan"], "train layer"),
                      chains=chains.get("lstm_bwd_scan")), "train layer"),
        with_f32(dict(entry("rnn_tanh_scan", rnn_type_checks["rnn_tanh_scan"], "serve layer"),
                      chains=chains.get("rnn_tanh_scan")), "serve layer"),
        with_f32(dict(entry("rnn_tanh_bwd_scan", rnn_type_checks["rnn_tanh_bwd_scan"],
                            "train layer"),
                      chains=chains.get("rnn_tanh_bwd_scan")), "train layer"),
    ]
    if not args.kernels:
        print(json.dumps({"lm_serving": lm_run, "card": card}))
        print(json.dumps({"surface": surface, "card": card}))
        print(json.dumps({"parallel": parallel, "card": card}))
        print(json.dumps({"gallery": gallery, "card": card}))
        print(json.dumps({"lookahead": {
            **lookahead, "serve_launches": {"phase 4": served["lookahead_launches"],
                                            "phase 5a": streamed["batch"]["lookahead_launches"],
                                            "phase 5a forwards": streamed["batch"]["forwards"]}},
            "card": card}))
        print(json.dumps({"float32": {k: v for k, v in float32.items() if k != "kernels"},
                          "card": card}))
    log(card)  # as nvidia-smi prints it: name, power limit
    gemm = {}
    if not args.kernels:  # the GEMM that B3's, B4's and B7's float32 entries launch
        gemm = {"float32_gemm": {
            "name": "sgemm_tma_kernel", "route": "cuda",
            "source": "danspeech_tpu_torch/csrc/sgemm.cuh",
            "inside": ["gru_bidi_fused", "gru_bwd_scan", "lstm_bwd_scan"],
            "launches": float32["gemm_launches"], "card": card, "shapes": float32["gemm"]}}
    print(json.dumps({"kernels": kernels, **gemm, "barrier_us": barrier["us"],
                      "card": card}))
    print(json.dumps({"b5_h1024": b5_h1024, "card": card}))
    print(json.dumps({"b5_h2048": b5_h2048, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
