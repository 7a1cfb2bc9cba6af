"""Run a function on n spawned ranks of a gloo process group on the CPU:
the rig of the port's parallel tests (tests/test_torch_*.py).

``run_ranks(fn, n, tmp_path, *args)`` starts n processes (the "spawn"
start method: each imports ``fn``'s module afresh, so that module imports
torch, numpy and the port only at its top, never JAX), joins them into one
group through a file store under ``tmp_path`` with a timeout on every
collective, calls ``fn(rank, n, *args)`` in each and returns the ranks'
results in rank order. A rank that raises, or a group that outlives the
deadline, fails the caller; every process is gone when it returns.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import traceback
from datetime import timedelta

import numpy as np

DEADLINE_S = 300
COLLECTIVE_TIMEOUT = timedelta(seconds=90)


def _rank_main(fn, rank: int, n: int, store: str, out: str, args) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=n, timeout=COLLECTIVE_TIMEOUT)
        result = fn(rank, n, *args)
        with open(out, "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, n: int, tmp_path, *args, deadline: float = DEADLINE_S) -> list:
    import time

    tmp = str(tmp_path)
    store = os.path.join(tmp, f"store_{fn.__name__}_{n}")
    outs = [os.path.join(tmp, f"rank_{fn.__name__}_{n}_{r}.pkl") for r in range(n)]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, n, store, outs[r], args))
             for r in range(n)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    try:
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = []
    for r, p in enumerate(procs):
        if os.path.exists(outs[r] + ".err"):
            with open(outs[r] + ".err") as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0:
            errors.append(f"rank {r}: exit code {p.exitcode}")
    if hung:
        errors.insert(0, f"ranks {hung} still ran after {deadline} s and were killed")
    if errors:
        raise AssertionError("\n".join(errors))
    results = []
    for out in outs:
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    return results


def jax_state_dict(cfg_kw: dict, seed: int, bn_seed: int | None = None) -> dict:
    """The JAX package's random weights for ``DeepSpeechConfig(**cfg_kw)``
    as a reference-named state dict of numpy arrays (BatchNorm statistics
    randomized with ``bn_seed``). Runs in the parent only: it imports JAX."""
    from danspeech_tpu.models import deepspeech as jds
    from danspeech_tpu.models.checkpoint import state_dict_from_params
    from danspeech_tpu.models.config import DeepSpeechConfig

    config = DeepSpeechConfig(**cfg_kw)
    params = jds.init_params(config, seed=seed)
    if bn_seed is not None:
        from test_model_parity import randomize_bn

        params = randomize_bn(params, seed=bn_seed)
    return {k: np.asarray(v) for k, v in state_dict_from_params(params, config).items()}


def port_model(cfg_kw: dict, state_dict: dict):
    """The port's model over a state dict (:func:`jax_state_dict`)."""
    from danspeech_tpu_torch.models import DeepSpeechModel
    from danspeech_tpu_torch.models.checkpoint import params_from_state_dict
    from danspeech_tpu_torch.models.config import DeepSpeechConfig

    config = DeepSpeechConfig(**cfg_kw)
    return DeepSpeechModel(config, params_from_state_dict(state_dict, config))


def jax_model(cfg_kw: dict, state_dict: dict):
    """The JAX package's model over the same state dict."""
    from danspeech_tpu.models import DeepSpeechModel
    from danspeech_tpu.models.checkpoint import params_from_state_dict
    from danspeech_tpu.models.config import DeepSpeechConfig

    config = DeepSpeechConfig(**cfg_kw)
    return DeepSpeechModel(config, params_from_state_dict(state_dict, config))
