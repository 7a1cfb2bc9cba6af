"""A (data, model) grid of ranks on ``torch.distributed``, and the
collectives the parallel modules use.

The port of ``danspeech_tpu/parallel/mesh.py``. One process runs each rank
and computes on one device; :func:`make_mesh` arranges the ranks of the
default process group row-major into an ``n_data x n_model`` grid (rank =
data index * n_model + model index, JAX's ``reshape(n_data, n_model)``) and
makes one subgroup per row and per column. Where the JAX package lets XLA
place collectives from sharding annotations, the modules here call the
helpers below, each with the semantics of its JAX primitive:

- :func:`axis_index`: the rank's index within an axis (``lax.axis_index``);
- :func:`psum`: the sum over an axis (``lax.psum``);
- :func:`all_gather`: the axis' tensors concatenated along a dimension
  (``lax.all_gather(..., tiled=True)``);
- :func:`ppermute`: a non-wrapping shift along an axis; the boundary rank
  receives zeros (``lax.ppermute`` with ``[(i, i + s)]``);
- :func:`broadcast`: one rank's tensor to the axis.

Each helper counts its calls in its ``calls`` attribute. An axis of one rank
runs no communication. The backend follows the device: NCCL for CUDA, gloo
for the CPU, or what the caller passes as ``backend=``. A gloo group whose
ranks compute on CUDA (two ranks sharing one card, which NCCL refuses)
passes every tensor through host memory, one rule for every helper,
whatever CUDA tensors the torch build's gloo takes: ``Mesh.transport``
names the route. Nothing moves to another backend or device by itself.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..utils.logging import get_logger

DATA_AXIS = "data"
MODEL_AXIS = "model"

# how long a collective may wait for its peers before it raises
DEFAULT_TIMEOUT = timedelta(seconds=300)

_log = get_logger("danspeech_tpu_torch.parallel")


class Mesh:
    """This rank's view of the (data, model) grid: the axis sizes, its
    index on each axis, the subgroup of each axis and its device."""

    def __init__(self, n_data: int, n_model: int, device: torch.device,
                 backend: str):
        self.shape = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
        self.device = device
        self.backend = backend
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        self.stage_through_host = backend == "gloo" and device.type == "cuda"
        self.transport = backend + (", staged through host memory"
                                    if self.stage_through_host else "")
        d, m = divmod(self.rank, n_model)
        self._index = {DATA_AXIS: d, MODEL_AXIS: m}
        self._ranks, self._groups = {}, {}
        # every rank creates every subgroup, in the same order
        for axis, lines in (
            (DATA_AXIS, [[i * n_model + j for i in range(n_data)] for j in range(n_model)]),
            (MODEL_AXIS, [[i * n_model + j for j in range(n_model)] for i in range(n_data)]),
        ):
            for ranks in lines:
                group = dist.new_group(ranks) if len(ranks) > 1 else None
                if self.rank in ranks:
                    self._ranks[axis], self._groups[axis] = ranks, group

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self._index[axis]

    def ranks(self, axis: str) -> list[int]:
        """The global ranks of this rank's subgroup along ``axis``."""
        return self._ranks[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]}, "
                f"rank={self.rank}, device={self.device}, transport={self.transport})")


def _pick_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None
                           else torch.cuda.current_device())
    return dev


def _backend(dev: torch.device, backend: str | None) -> str:
    want = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if want == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return want


def _init_group(backend: str) -> None:
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        # a launcher (torchrun)
        dist.init_process_group(backend, timeout=DEFAULT_TIMEOUT)
    else:
        # no launcher: this process is the only rank
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=DEFAULT_TIMEOUT)


def make_mesh(n_data: int | None = None, n_model: int = 1, device=None,
              backend: str | None = None) -> Mesh:
    """This rank's (data, model) mesh over the default process group.

    Without a group, one is made: from the launcher's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as
    ``torchrun`` sets them), else a group of this process alone from a local
    store. ``device`` is this rank's device (None: CUDA, ``cuda:LOCAL_RANK``
    under a launcher; raising without a GPU); ``backend`` defaults to NCCL
    for CUDA and gloo for the CPU, and a group already made with another
    backend raises. ``n_data`` defaults to the world size over ``n_model``
    (all ranks on the data axis).
    """
    dev = _pick_device(device)
    want = _backend(dev, backend)
    if not dist.is_initialized():
        _init_group(want)
    have = dist.get_backend()
    if have != want:
        raise ValueError(f"the process group runs {have}, not the {want} that {dev} "
                         f"needs; pass backend={have!r} to compute on {dev} over it")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} does not cover {world} ranks")
    mesh = Mesh(n_data, n_model, dev, have)
    _log.info(f"mesh {n_data}x{n_model} rank {mesh.rank} on {dev}: {mesh.transport}")
    return mesh


class Placement(NamedTuple):
    """How a tensor lies on the mesh: split along dimension ``dim`` over the
    mesh axis ``axis``, or whole on every rank (both None)."""

    axis: str | None
    dim: int | None


def data_sharding(mesh: Mesh) -> Placement:
    """Where batch inputs go: rows split over the data axis."""
    return Placement(DATA_AXIS, 0)


def replicated(mesh: Mesh) -> Placement:
    """A tensor every rank holds whole."""
    return Placement(None, None)


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, device=None,
                         backend: str | None = None) -> None:
    """Join this process to a process group of ``num_processes``, rank
    ``process_id``, whose rendezvous is ``coordinator_address``
    (``host:port``, served by rank 0). Without an address the launcher's
    environment is read (``init_method="env://"``). The backend follows
    ``device`` as in :func:`make_mesh`; call :func:`make_mesh` afterwards."""
    want = _backend(_pick_device(device), backend)
    if coordinator_address is None:
        dist.init_process_group(want, timeout=DEFAULT_TIMEOUT)
    else:
        dist.init_process_group(
            want, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, timeout=DEFAULT_TIMEOUT,
        )


# ---------------------------------------------------------------------------
# Collectives with JAX semantics
# ---------------------------------------------------------------------------


def _wire(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    x = x.detach().contiguous()
    return x.cpu() if mesh.stage_through_host else x


def _home(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    return x.to(mesh.device) if mesh.stage_through_host else x


def axis_index(mesh: Mesh, axis: str) -> int:
    """This rank's index along ``axis`` (``lax.axis_index``)."""
    axis_index.calls += 1
    return mesh.index(axis)


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, on every one of them."""
    psum.calls += 1
    if mesh.size(axis) == 1:
        return x
    buf = _wire(mesh, x).clone()
    dist.all_reduce(buf, group=mesh.group(axis))
    return _home(mesh, buf)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' tensors of ``axis`` concatenated along ``dim``, in rank
    order (``lax.all_gather(..., tiled=True)``). Every rank passes the same
    shape."""
    all_gather.calls += 1
    if mesh.size(axis) == 1:
        return x
    src = _wire(mesh, x)
    parts = [torch.empty_like(src) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, src, group=mesh.group(axis))
    return _home(mesh, torch.cat(parts, dim=dim))


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str, shift: int) -> torch.Tensor:
    """Rank i of ``axis`` sends ``x`` to rank i + shift and returns what rank
    i - shift sent; a rank with no sender gets zeros (a non-wrapping
    ``lax.ppermute``)."""
    ppermute.calls += 1
    n, i = mesh.size(axis), mesh.index(axis)
    src = _wire(mesh, x)
    buf = torch.zeros_like(src)
    ranks = mesh.ranks(axis)
    ops = []
    if 0 <= i + shift < n:
        ops.append(dist.P2POp(dist.isend, src, ranks[i + shift], mesh.group(axis)))
    if 0 <= i - shift < n:
        ops.append(dist.P2POp(dist.irecv, buf, ranks[i - shift], mesh.group(axis)))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _home(mesh, buf)


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str, src: int) -> torch.Tensor:
    """Rank ``src`` of ``axis``' tensor on every rank of the axis."""
    broadcast.calls += 1
    if mesh.size(axis) == 1:
        return x
    buf = _wire(mesh, x).clone()
    dist.broadcast(buf, mesh.ranks(axis)[src], group=mesh.group(axis))
    return _home(mesh, buf)


for _fn in (axis_index, psum, all_gather, ppermute, broadcast):
    _fn.calls = 0


def collective_calls() -> int:
    """The helpers' calls so far, summed (axis_index excluded: it moves
    nothing)."""
    return psum.calls + all_gather.calls + ppermute.calls + broadcast.calls
