#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (danspeech_tpu_torch).

    python3 chip_smoke.py            # every phase, needs one CUDA card
    python3 chip_smoke.py --kernels  # phases 1-3 only (build + kernel checks)

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA kernel from ``danspeech_tpu_torch/csrc`` (one nvcc per
   source, all started together), timed;
3. each kernel against its plain PyTorch version on the card at a ragged
   small shape and the layer shapes of the paths below, with its time, the
   plain version's time, one library call's time as a yardstick, and the
   bound;
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
6. one ``{"kernels": [...]}`` line, then the device line as the last line.

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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else ""


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
    from danspeech_tpu_torch.ops import gru_cuda

    args = gru_layer_inputs(gen, t, b, d, h, lengths)
    got = gru_cuda.gru_bidi_fused(*args)
    torch.cuda.synchronize()
    ref = gru_cuda.gru_bidi_fused_plain(*args)
    torch.cuda.synchronize()
    names = ("out_f", "out_b", "h_last_f", "h_last_b")
    errs = {}
    for name, g, r in zip(names, got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs {r.shape}/{r.dtype}")
        if not torch.isfinite(g.float()).all():
            raise AssertionError(f"{name}: non-finite values from the kernel")
        errs[name] = float((g.float() - r.float()).abs().max())
    # rows past their length must be exact zeros
    tt = torch.arange(t, device="cuda")[:, None]
    pad = tt >= args[1][None, :].long()
    for name, g in zip(names[:2], got[:2]):
        if pad.any() and float(g[pad].float().abs().max()) != 0.0:
            raise AssertionError(f"{name}: non-zero output past a row's length")
    err = max(errs.values())
    res = {
        "shape": {"T": t, "B": b, "D": d, "H": h},
        "max_abs_err": err, "errs": errs, "atol": GRU_ATOL,
    }
    log(f"  gru_bidi_fused T={t} B={b} D={d} H={h}: max|err| "
        + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f" (atol {GRU_ATOL})")
    if not err <= GRU_ATOL:
        raise AssertionError(f"gru_bidi_fused disagrees with its plain version: {err}")
    if timed:
        res["ms"] = time_ms(lambda: gru_cuda.gru_bidi_fused(*args), iters=3)
        res["plain_ms"] = time_ms(lambda: gru_cuda.gru_bidi_fused_plain(*args), iters=2)
        gru = torch.nn.GRU(d, h, bidirectional=True).to("cuda", torch.bfloat16)
        gru.flatten_parameters()  # cuDNN wants its weights in one block
        x = args[0]
        with torch.no_grad():
            res["library_ms"] = time_ms(lambda: gru(x), iters=3)
        del gru
        res["bound_ms"], res["bound_by"] = gru_bound(t, b, d, h)
        log(f"    ms={res['ms']:.3f} plain_ms={res['plain_ms']:.3f} "
            f"library_ms(cuDNN nn.GRU bf16)={res['library_ms']:.3f} "
            f"bound_ms={res['bound_ms']:.3f} ({res['bound_by']})")
    del args, got, ref
    torch.cuda.empty_cache()
    return res


def phase_kernels():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    small = check_gru(gen, 37, 5, 96, 64, [37, 1, 20, 36, 5], timed=False)
    flag = []
    for d in (2016, 1200):
        rng = np.random.default_rng(d)
        lengths = rng.integers(1, 402, size=128)
        lengths[0], lengths[1] = 401, 1
        flag.append(check_gru(gen, 401, 128, d, 1200, lengths.tolist(), timed=True))
    return [small] + flag


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


def check_scan(gen, label, t, lengths, h, reverse, carried, timed):
    from danspeech_tpu_torch.ops import gru_cuda

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
    args = (gx, lens, w_hh, b_ih, b_hh, h0)
    got = gru_cuda.gru_scan(*args, reverse=reverse)
    torch.cuda.synchronize()
    ref = gru_cuda.gru_scan_plain(*args, reverse=reverse)
    torch.cuda.synchronize()
    errs = {}
    for name, g, r in zip(("out", "h_last"), got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs {r.shape}/{r.dtype}")
        if not torch.isfinite(g.float()).all():
            raise AssertionError(f"{name}: non-finite values from the kernel")
        errs[name] = float((g.float() - r.float()).abs().max())
    pad = torch.arange(t, device=dev)[:, None] >= lens[None, :].long()
    if pad.any() and float(got[0][pad].float().abs().max()) != 0.0:
        raise AssertionError("gru_scan: non-zero output past a row's length")
    err = max(errs.values())
    res = {"label": label,
           "shape": {"T": t, "B": b, "H": h, "reverse": reverse, "carried_h0": carried},
           "max_abs_err": err, "errs": errs, "atol": GRU_ATOL}
    log(f"  gru_scan {label} T={t} B={b} H={h} reverse={reverse} "
        f"h0={'carried' if carried else 'zero'}: max|err| "
        + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()) + f" (atol {GRU_ATOL})")
    if not err <= GRU_ATOL:
        raise AssertionError(f"gru_scan disagrees with its plain version: {err}")
    if timed:
        res["ms"] = time_ms(lambda: gru_cuda.gru_scan(*args, reverse=reverse), iters=5)
        res["plain_ms"] = time_ms(
            lambda: gru_cuda.gru_scan_plain(*args, reverse=reverse), iters=2)
        # cuDNN's GRU(D=H, H) on (T, B, H): it also computes the input
        # projection, which gru_scan takes precomputed
        gru = torch.nn.GRU(h, h).to(dev, torch.bfloat16)
        gru.flatten_parameters()
        x = torch.randn(t, b, h, generator=gen, device=dev).to(torch.bfloat16)
        with torch.no_grad():
            res["library_ms"] = time_ms(lambda: gru(x), iters=5)
        del gru, x
        res["bound_ms"], res["bound_by"] = scan_bound(lengths, t, b, h)
        log(f"    ms={res['ms']:.3f} plain_ms={res['plain_ms']:.3f} "
            f"library_ms(cuDNN nn.GRU({h},{h}) bf16, with its projection)="
            f"{res['library_ms']:.3f} bound_ms={res['bound_ms']:.4f} ({res['bound_by']})")
    del args, got, ref
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
    for lengths in ([13], [13, 1, 7, 12, 3]):  # B = 1 and B = 5, H % 64 != 0
        for reverse in (False, True):
            checks.append(check_scan(gen, "small", 13, lengths, 72, reverse, carried=True,
                                     timed=len(lengths) == 5 and not reverse))
    rng = np.random.default_rng(2000)
    lengths = rng.integers(1, 402, size=128)
    lengths[0], lengths[1] = 401, 1
    checks.append(check_scan(gen, "uni batch layer", 401, lengths.tolist(), 2000,
                             False, carried=False, timed=True))
    checks.append(check_scan(gen, "streaming step", STREAM_T, [STREAM_VALID], 2000,
                             False, carried=True, timed=True))
    return checks


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


def profile_call(label, fn, top=12):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's busy share of the call's wall time."""
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
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "top": [{"kernel": n, "ms": ms, "count": c} for n, ms, c in rows[:top]]}


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
    serve = []
    for kind, what, samples, wall in calls:
        audio_s = samples / 16000.0
        serve.append({"call": kind, "input": what, "audio_s": audio_s,
                      "wall_s": wall, "audio_s_per_s": audio_s / wall})
        log(f"  {kind}({what}): {audio_s:.2f} audio-s in {wall:.3f} s = "
            f"{audio_s / wall:.1f} audio-s/s [{card}]")

    profile = profile_call("one recognize_batch",
                           lambda: rec.recognize_batch(batches[1]))

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
    out["batch"] = {"launches": batch_launches, "serve": serve}
    out["batch"]["profile"] = profile_call(
        "one uni recognize_batch", lambda: rec.recognize_batch(batches[1]))
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
                 for c, _, _ in plan[1:4]])
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
    out["real_time"] = {"wall_s": wall, "partials": len(partials),
                        "scan_launches": scan_rts, "bidi_launches": bidi_rts,
                        "vs_plain": check_stream_chunks("real_time_streaming", eng, steps)}
    out["scan_launches"] = batch_launches + scan_direct + scan_rts
    out["bidi_launches"] = bidi_direct + bidi_rts
    return out


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true",
                    help="run phases 1-3 only (build and kernel checks)")
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

    # phase 2
    t0 = time.perf_counter()
    build_logs = cuda_build.build("gru_bidi_fused", "gru_scan")
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    # phase 3
    log("phase 3: kernels vs plain versions")
    gru_checks = phase_kernels()
    scan_checks = phase_scan_kernels()

    launches = scan_launches = None
    if not args.kernels:
        log("phase 4: batch path (Recognizer on the flagship)")
        served = phase_serve(card)
        log("phase 5: streaming path (GPUStreamingRNN, flagship secondary)")
        streamed = phase_stream(card)
        launches = served["launches"] + streamed["bidi_launches"]
        scan_launches = streamed["scan_launches"]

    flag0 = gru_checks[1]
    scan0 = next(c for c in scan_checks if c["label"] == "uni batch layer")
    kernels = [{
        "name": "gru_bidi_fused",
        "route": "cuda",
        "source": "danspeech_tpu_torch/csrc/gru_bidi_fused.cu",
        "replaces": "danspeech_tpu/ops/pallas_gru.py:400",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in gru_checks),
        "ms": flag0["ms"], "plain_ms": flag0["plain_ms"],
        "bound_ms": flag0["bound_ms"], "bound_by": flag0["bound_by"],
        "library_ms": flag0["library_ms"],
        "shapes": gru_checks,
    }, {
        "name": "gru_scan",
        "route": "cuda",
        "source": "danspeech_tpu_torch/csrc/gru_scan.cu",
        "replaces": "danspeech_tpu/ops/pallas_gru.py:770",
        "launches": scan_launches,
        "max_abs_err": max(c["max_abs_err"] for c in scan_checks),
        "ms": scan0["ms"], "plain_ms": scan0["plain_ms"],
        "bound_ms": scan0["bound_ms"], "bound_by": scan0["bound_by"],
        "library_ms": scan0["library_ms"],
        "shapes": scan_checks,
    }]
    log(card)  # as nvidia-smi prints it: name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
