"""ctypes bridge to the native C++ beam-search decoder (native/ctcbeam).

The port compiles the repository's ``native/ctcbeam/ctcbeam.cc`` with
``g++`` at first use (never at import) into ``danspeech_tpu_torch/build/``,
beside the CUDA kernels; the library's name carries a hash of the source,
so an edited source is rebuilt. Raises on failure — BeamCTCDecoder catches
and falls back to the pure-Python implementation. Otherwise a copy of
``danspeech_tpu.decode.native_beam``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

from .lm import PackedNgramLM

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "ctcbeam", "ctcbeam.cc")
BUILD_DIR = os.path.join(_PKG, "build")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def _word_hash(word: str) -> int:
    """FNV-1a over utf-8 bytes; must match WordHash in ctcbeam.cc."""
    h = _FNV_OFFSET
    for b in word.encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h if h != 0 else 1


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libctcbeam-{digest}.so")


def _ensure_built() -> str:
    """Compile the C++ source into BUILD_DIR unless it is built already."""
    dst = library_path()
    if not os.path.exists(dst):
        cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{dst}.{os.getpid()}.tmp"
        subprocess.run(
            [cxx, *CXX_FLAGS, "-o", tmp, SOURCE, "-lpthread"],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, dst)
    return dst


_lib = None


def _load_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_ensure_built())
        lib.ctcbeam_create.restype = ctypes.c_void_p
        lib.ctcbeam_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_char_p,
        ]
        lib.ctcbeam_set_lm.restype = None
        lib.ctcbeam_set_lm.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            ctypes.c_int,
        ]
        lib.ctcbeam_set_lm_kenlm_begin.restype = None
        lib.ctcbeam_set_lm_kenlm_begin.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
        ]
        lib.ctcbeam_set_lm_kenlm_table.restype = None
        lib.ctcbeam_set_lm_kenlm_table.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_void_p,  # backoffs: float* or NULL for the longest order
            ctypes.c_int64,
        ]
        lib.ctcbeam_decode_batch.restype = ctypes.c_int
        lib.ctcbeam_decode_batch.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
        ]
        lib.ctcbeam_destroy.restype = None
        lib.ctcbeam_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def _vocab_table(vocab: dict[str, int]):
    """Open-addressing (hash -> id) table matching the C++ probe loop."""
    size = max(8, int(len(vocab) * 1.5))
    keys = np.zeros(size, dtype=np.uint64)
    ids = np.zeros(size, dtype=np.int32)
    for word, wid in vocab.items():
        h = _word_hash(word)
        i = h % size
        while keys[i] != 0:
            i = (i + 1) % size
        keys[i] = h
        ids[i] = wid
    return keys, ids


class NativeBeamDecoder:
    """Thin handle over the C++ decoder; one instance per decoder config."""

    def __init__(
        self,
        labels: str,
        lm=None,
        alpha: float = 0.0,
        beta: float = 0.0,
        cutoff_top_n: int = 40,
        cutoff_prob: float = 1.0,
        beam_width: int = 64,
        num_threads: int = 4,
        blank_index: int = 0,
        space_index: int | None = None,
    ):
        lib = _load_lib()
        self._lib = lib
        self.labels = labels
        self.beam_width = beam_width
        if space_index is None:
            space_index = labels.index(" ") if " " in labels else len(labels)

        label_bytes = "\n".join(labels).encode("utf-8")
        self._handle = lib.ctcbeam_create(
            len(labels), blank_index, space_index, beam_width,
            cutoff_top_n, cutoff_prob, alpha, beta, num_threads, label_bytes,
        )
        self._lm_buffers = None
        from .kenlm_reader import KenLMProbingModel

        if isinstance(lm, KenLMProbingModel):
            self._set_kenlm(lm)
        elif lm is not None:
            packed = lm if isinstance(lm, PackedNgramLM) else PackedNgramLM(lm)
            vk, vi = _vocab_table(packed.vocab)
            # hold references so the C++ copies from live memory
            self._lm_buffers = (packed.keys, packed.probs, packed.backoffs, vk, vi)
            lib.ctcbeam_set_lm(
                self._handle,
                np.ascontiguousarray(packed.keys),
                np.ascontiguousarray(packed.probs),
                np.ascontiguousarray(packed.backoffs),
                packed.size,
                vk, vi, vk.shape[0], packed.order,
            )

    def _set_kenlm(self, model) -> None:
        """Hand the KenLM probing tables (already natural-log) to C++."""
        lib = self._lib
        unigram = np.ascontiguousarray(model._unigram, dtype=np.float32)
        vkeys, vids = model._vocab_hash
        vkeys = np.ascontiguousarray(vkeys, dtype=np.uint64)
        vids = np.ascontiguousarray(vids, dtype=np.uint32)
        lib.ctcbeam_set_lm_kenlm_begin(
            self._handle, model.order, unigram.reshape(-1),
            unigram.shape[0], vkeys, vids, vkeys.shape[0],
        )
        keep = [unigram, vkeys, vids]
        for i, table in enumerate(model._middles):
            keys = np.ascontiguousarray(table.keys, dtype=np.uint64)
            probs = np.ascontiguousarray(table.probs, dtype=np.float32)
            backs = np.ascontiguousarray(table.backoffs, dtype=np.float32)
            lib.ctcbeam_set_lm_kenlm_table(
                self._handle, i + 2, keys, probs,
                backs.ctypes.data_as(ctypes.c_void_p), keys.shape[0],
            )
            keep += [keys, probs, backs]
        lg = model._longest
        keys = np.ascontiguousarray(lg.keys, dtype=np.uint64)
        probs = np.ascontiguousarray(lg.probs, dtype=np.float32)
        lib.ctcbeam_set_lm_kenlm_table(
            self._handle, model.order, keys, probs, None, keys.shape[0]
        )
        keep += [keys, probs]
        self._lm_buffers = tuple(keep)

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.ctcbeam_destroy(self._handle)
                self._handle = None
        except Exception:
            pass

    def decode(self, probs: np.ndarray):
        """(T, C) probabilities -> [(labels tuple, score, times tuple)]."""
        results = self.decode_batch(probs[None], np.array([probs.shape[0]], np.int32))
        return results[0]

    def decode_batch(self, probs: np.ndarray, lengths: np.ndarray):
        probs = np.ascontiguousarray(probs, dtype=np.float32)
        lengths = np.ascontiguousarray(lengths, dtype=np.int32)
        batch, t_max, num_classes = probs.shape
        max_len = t_max + 1
        bw = self.beam_width
        out_labels = np.zeros((batch, bw, max_len), dtype=np.int32)
        out_times = np.zeros((batch, bw, max_len), dtype=np.int32)
        out_lens = np.zeros((batch, bw), dtype=np.int32)
        out_scores = np.zeros((batch, bw), dtype=np.float32)
        out_num = np.zeros(batch, dtype=np.int32)
        rc = self._lib.ctcbeam_decode_batch(
            self._handle, probs, batch, t_max, num_classes, lengths,
            out_labels.reshape(-1), out_times.reshape(-1),
            out_lens.reshape(-1), out_scores.reshape(-1), out_num, max_len,
        )
        if rc != 0:
            raise RuntimeError(f"native beam decode failed (rc={rc})")
        all_results = []
        for b in range(batch):
            rows = []
            for k in range(int(out_num[b])):
                n = int(out_lens[b, k])
                rows.append(
                    (
                        tuple(out_labels[b, k, :n].tolist()),
                        float(out_scores[b, k]),
                        tuple(out_times[b, k, :n].tolist()),
                    )
                )
            all_results.append(rows)
        return all_results
