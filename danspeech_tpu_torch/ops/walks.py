"""One dispatcher for the port's recurrent kernels (B1-B9).

Each kernel wrapper of ``gru_cuda``, ``lstm_cuda`` and ``rnn_tanh_cuda``
describes its kernel once, as a :class:`Walk`, and hands one chain, or the
two chains of a bidirectional layer, to :func:`run`, which decides how they
run and counts what it launched:

- CPU tensors run the plain version, one call a chain; any other device
  than CUDA raises;
- both chains must share their shapes and lengths, and be one operand set:
  bf16 sequences and weights with f32 biases and states, or everything
  float32 (the float32 variants);
- the plan of that set (``persist_plan``, from the shape and the card's SM
  count and shared memory): both chains in one cooperative launch where the
  two-chain plan fits, else one launch a chain where the one-chain plan
  does, else the step design (one launch a time step, from the C entry's
  host loop). ``design=`` asks for a design, which the plan must allow;
- the launch and the count.

The counting rule: ``launches``, ``design_counts`` and ``dtype_counts`` of
a wrapper grow by the C calls it issued (a cooperative launch over two
chains is one, and so is the step design's run of T launches), ``chains``
by the chains those calls walked. Where a wrapper's bf16 persistent design
is another wrapper's kernel, those launches count on the kernel's owner
(B2's ``gru_scan_persist_kernel`` on ``gru_scan``, B6's
``lstm_persist_kernel`` on ``lstm_scan``), so that a counter equals its
kernel's launches on every path.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import torch

from . import cuda_build
from .cuda_checks import count
from .persist_plan import DESIGNS

_device_info: dict[int, tuple[int, int]] = {}


def device_info(device: torch.device) -> tuple[int, int]:
    """(SM count, bytes of shared memory one block may opt in to) of a CUDA
    device, as the CUDA runtime reports them."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _device_info:
        fn = cuda_build.load("gru_bwd").persist_device_info
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        fn.restype = ctypes.c_int
        sms, smem = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(index):
            rc = fn(ctypes.byref(sms), ctypes.byref(smem))
        if rc != 0:
            raise RuntimeError(f"persist_device_info failed: CUDA error {rc}")
        _device_info[index] = (sms.value, smem.value)
    return _device_info[index]


@dataclasses.dataclass(frozen=True)
class Walk:
    """One kernel as :func:`run` drives it. A chain is the wrapper's operand
    tuple: the sequence (T, B, .) first, lengths at ``lengths_at``, w_hh
    (H, .) at ``w_at``. Each launcher is one C call over the chains it is
    given and returns a result a chain: ``persistent(chains, reverses,
    plan)`` and ``step(chains, reverses)`` for the bf16 set (``step`` takes
    ``step_chains`` chains at a time), ``persistent_f32`` and ``step_f32``
    (up to two chains) for the float32 set."""

    check: Callable      # (*chain) -> the chain's set, torch.bfloat16 or torch.float32
    plain: Callable      # (*chain, reverse=) -> the chain's result, on any device
    plan: Callable       # (hidden, batch, chains, sm_count, smem_optin) -> PersistPlan
    plan_f32: Callable   # the same for the float32 set -> F32Plan
    persistent: Callable
    step: Callable
    persistent_f32: Callable
    step_f32: Callable
    counter: Callable    # the wrapper whose counters grow
    owner: Callable | None = None  # counts the bf16 persistent launches instead
    lengths_at: int = 1
    w_at: int = 2
    step_chains: int = 1


def each(step: Callable) -> Callable:
    """A step launcher of one chain, ``step(*chain, reverse)``, as a
    :class:`Walk` takes it."""
    return lambda chains, reverses: [step(*chains[0], reverses[0])]


def counted(wrapper: Callable) -> Callable:
    """Gives ``wrapper`` the counters :func:`run` keeps."""
    wrapper.launches = wrapper.chains = 0
    wrapper.design_counts = dict.fromkeys(DESIGNS, 0)
    wrapper.dtype_counts = {"bfloat16": 0, "float32": 0}
    return wrapper


def choose(design: str | None, planned) -> str:
    """The design taken: the plan's when ``design`` is None, else the one
    asked for, which must be one the plan allows ("step" always is)."""
    if design is None:
        return planned.design
    if design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}: one of {DESIGNS} or None")
    if design == "persistent" and planned.design != "persistent":
        raise ValueError(f"the persistent design does not fit: {planned.reason}")
    return design


def plan_of(walk: Walk, hidden: int, batch: int, chains: int, info: tuple[int, int],
            dtype: torch.dtype = torch.bfloat16) -> tuple:
    """(the plan :func:`run` takes for ``chains`` chains of ``walk`` on a
    device of ``info`` (:func:`device_info`) in the set ``dtype``, whether it
    walks them one launch a chain): the two-chain plan where it fits, else
    the one-chain plan."""
    planner = walk.plan_f32 if dtype == torch.float32 else walk.plan
    planned = planner(hidden, batch, chains, *info)
    if chains == 1 or planned.design == "persistent":
        return planned, False
    return planner(hidden, batch, 1, *info), True


def run(walk: Walk, chains, reverses, design: str | None = None) -> list:
    """The chains (one or two operand tuples, ``reverses`` their flags) of
    ``walk`` run as the module's docstring says; returns a result a chain."""
    if len(chains) == 2:
        a, b = chains
        if (tuple(a[0].shape) != tuple(b[0].shape)
                or tuple(a[walk.w_at].shape) != tuple(b[walk.w_at].shape)
                or a[walk.lengths_at] is not b[walk.lengths_at]):
            raise ValueError("the two chains must share their shapes and lengths")
    device = chains[0][0].device
    if device.type == "cpu":
        return [walk.plain(*c, reverse=r) for c, r in zip(chains, reverses)]
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    dtype = walk.check(*chains[0])
    if any(walk.check(*c) != dtype for c in chains[1:]):
        raise TypeError("the two chains' operands must be one set: bf16 or float32")
    f32 = dtype == torch.float32
    planned, apart = plan_of(walk, chains[0][walk.w_at].shape[0], chains[0][0].shape[1],
                             len(chains), device_info(device), dtype)
    design = choose(design, planned)
    counter = walk.counter
    if design == "persistent":
        launch, plan = walk.persistent_f32 if f32 else walk.persistent, (planned,)
        per = 1 if apart else len(chains)
        counter = walk.counter if f32 else walk.owner or walk.counter
    else:
        launch, plan = walk.step_f32 if f32 else walk.step, ()
        per = 2 if f32 else walk.step_chains
    results = []
    for k in range(0, len(chains), per):
        results += launch(chains[k:k + per], reverses[k:k + per], *plan)
    count(counter, design, dtype, -(-len(chains) // per))
    counter.chains += len(chains)
    return results
