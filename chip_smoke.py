#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (danspeech_tpu_torch).

    python3 chip_smoke.py            # every phase, needs one CUDA card
    python3 chip_smoke.py --kernels  # phases 1-3 only (build + kernel checks)

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA kernel from ``danspeech_tpu_torch/csrc`` (one nvcc per
   source, all started together), timed;
3. each kernel against its plain PyTorch version on the card at a ragged
   small shape and the flagship's layer shapes, with its time, the plain
   version's time, one library call's time as a yardstick, and the bound;
4. the main path: ``Recognizer.recognize`` / ``recognize_batch`` on the
   flagship DanSpeechPrimary (3 conv, 9x1200 bidirectional GRU, random
   weights from a seed), with the kernels' launch counts read around it,
   one batch checked against the plain GRU on the card, and a small model
   checked against the port's CPU path;
5. one ``{"kernels": [...]}`` line, then the device line as the last line.

Imports no JAX and nothing of ``danspeech_tpu``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

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


# ---------------------------------------------------------------------------
# Phase 4: the main path
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


def profile_batch(rec, batch, top=12):
    """Device time by kernel over one recognize_batch call (torch.profiler),
    and the device's busy share of the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rec.recognize_batch(batch)
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
    log(f"  profile of one recognize_batch: wall {wall_ms:.1f} ms, device busy "
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

    profile = profile_batch(rec, batches[1])

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
    build_logs = cuda_build.build("gru_bidi_fused")
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    # phase 3
    log("phase 3: kernels vs plain versions")
    gru_checks = phase_kernels()

    launches = None
    if not args.kernels:
        log("phase 4: main path (Recognizer on the flagship)")
        served = phase_serve(card)
        launches = served["launches"]

    flag0 = gru_checks[1]
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
    }]
    log(card)  # as nvidia-smi prints it: name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
