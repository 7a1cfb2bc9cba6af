"""The one generator of traffic: a mix's parameters (``traffic/<name>.json``)
and the seed give the pool of calls a run cycles over.

Lengths are stratified: the pool's ``calls * rows_per_call`` utterances
take one length from each of as many equal strata of ``[min_s, max_s]``
(uniform within the stratum), call c holding strata c, c + calls, ... So
every seed serves the same spread of lengths, each call spans the whole
range, and the seed changes the content and the order. The samples are
Gaussian noise of the mix's amplitude, drawn on the device in one call, in
bursts of random length and loudness (``burst_s``, ``burst_db``), as
int16 PCM: like speech, the spectrogram changes from burst to burst, so the
models' greedy paths change over time (steady noise drove GPUStreamingRNN
to one label on every frame).
"""

from __future__ import annotations

import numpy as np
import torch


def derived_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one of the benchmark's random streams."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)[0] >> 1)


def lengths(mix: dict, seed: int) -> np.ndarray:
    """(calls, rows_per_call) sample counts."""
    calls, rows = mix["calls"], mix["rows_per_call"]
    n = calls * rows
    rng = np.random.default_rng(derived_seed(seed, 1))
    strata = (np.arange(n) + rng.random(n)) / n
    seconds = mix["min_s"] + (mix["max_s"] - mix["min_s"]) * strata
    out = np.round(seconds * mix["sample_rate"]).astype(np.int64).reshape(rows, calls).T
    return out[rng.permutation(calls)]


def envelope(mix: dict, seed: int, total: int) -> tuple:
    """Piecewise-constant gains over the pool's ``total`` samples: bursts of
    ``burst_s`` [lo, hi] seconds, each at a gain drawn in dB from
    ``burst_db`` [lo, hi], as (gains, burst lengths in samples)."""
    rng = np.random.default_rng(derived_seed(seed, 3))
    lo, hi = (round(s * mix["sample_rate"]) for s in mix["burst_s"])
    n = total // lo + 1
    runs = rng.integers(lo, hi + 1, size=n)
    runs = runs[: int(np.searchsorted(np.cumsum(runs), total)) + 1]
    runs[-1] -= int(runs.sum()) - total
    gains = 10.0 ** (rng.uniform(*mix["burst_db"], size=len(runs)) / 20.0)
    return gains.astype(np.float32), runs


def pool(mix: dict, seed: int, device) -> list:
    """The pool: a list of calls, each a list of ``rows_per_call`` int16
    numpy waveforms (host memory, as a caller hands them over)."""
    lens = lengths(mix, seed)
    total = int(lens.sum())
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, 2))
    noise = torch.randn(total, generator=gen, device=device)
    gains, runs = envelope(mix, seed, total)
    noise.mul_(torch.repeat_interleave(torch.from_numpy(gains).to(device),
                                       torch.from_numpy(runs).to(device)))
    pcm = noise.mul_(mix["amplitude"]).round_().clamp_(-32768, 32767).to(torch.int16)
    flat = pcm.cpu().numpy()
    bounds = np.cumsum(lens.ravel())[:-1]
    waves = np.split(flat, bounds)
    rows = lens.shape[1]
    return [waves[c * rows : (c + 1) * rows] for c in range(lens.shape[0])]
