"""Build the port's CUDA sources (``csrc/*.cu``) into shared libraries.

Each source is compiled by ``nvcc`` on its own into a library with a plain C
interface, loaded with ctypes. The build happens at first use into
``danspeech_tpu_torch/build/`` (listed in ``.gitignore``); the file name
carries a hash of the source and of the shared headers (``csrc/*.cuh``), so
an edited source is rebuilt. There is no fallback: a missing ``nvcc`` or a
failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
]

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``. Raises RuntimeError if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built"
    )


def library_path(name: str) -> str:
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(*names: str) -> dict[str, str]:
    """Compile the named sources that are not built yet, all ``nvcc``
    processes started together. Returns {name: compiler output} for the
    sources compiled by this call (empty output for ones already built)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    running = {}
    logs = {}
    for name in names:
        dst = library_path(name)
        if os.path.exists(dst):
            logs[name] = ""
            continue
        nvcc = nvcc or nvcc_path()
        tmp = f"{dst}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, dst)
    failed = []
    for name, (proc, tmp, dst) in running.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, dst)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
    return lib


def bind(name: str, fn_name: str, n_ptr: int, n_int: int):
    """The C entry ``fn_name`` of ``csrc/<name>.cu`` with its ctypes
    signature set: ``n_ptr`` pointers, ``n_int`` ints, then the stream;
    it returns ``cudaGetLastError()`` as an int."""
    fn = getattr(load(name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def chain_ptrs(tensors) -> list:
    """The two per-chain pointers of a launch over one or two chains: each
    tensor's data pointer (None stays None); a single chain fills both."""
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    return ptrs + ptrs[:1] * (2 - len(ptrs))


def call(fn, name: str, device, *args) -> None:
    """Call a bound C entry (:func:`bind`) with ``args`` and the current
    stream of the CUDA ``device``; raise if it returns a CUDA error."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
