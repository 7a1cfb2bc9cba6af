"""Inference engine: model/decoder lifecycle, batch and streaming
transcription.

The port of the batch and streaming paths of ``danspeech_tpu/engine.py``.
Batch: the device program (int16/float32 waveforms -> spectrogram -> conv
-> RNN stack -> head -> softmax, and the argmax when the decoder is greedy;
for a Mozilla DeepSpeech model, ``config.family == "mozilla"``, MFCC ->
context windows -> dense layers -> LSTM -> dense head, ``models/mozilla.py``)
runs on the engine's device; the waveforms, sorted by length, are cut into
dispatch groups of at most 128 rows at the least cost of padded volume and
recurrent walk (:meth:`DanSpeechRecognizer._plan_groups`), every group is
staged in pinned host memory, uploaded and enqueued before the host decodes
the first group, so host decoding overlaps the device work of later groups.
With a language model each group's decoder is resolved by its row count: the device beam
search reads the probabilities where they are, the host beam gets them
through a pinned asynchronous copy with the pad rows sliced off.
Streaming: the host parses each chunk's spectrogram, pads it to a
CHUNK_BUCKET multiple and runs the masked chunk step
(``models/streaming.py``) on state kept on the device; greedy partials per
chunk, and on the final chunk either a secondary model re-transcribes the
whole stream or the LM decoder re-decodes the stream's probabilities.

The device is CUDA unless the caller passes ``device="cpu"``.
``compute_dtype="float32"`` serves in float32 on either device: on CUDA the
recurrent kernels' float32 variants (``csrc/gru_f32.cu``, ``csrc/lstm_f32.cu``,
``csrc/rnn_tanh_f32.cu``, for every ``rnn_type``) and every other product in
full float32, TF32 off (``ops/precision.py``). With
``transfer_format="ulaw"`` the rows cross as G.711 mu-law bytes, one a
sample, and :func:`ulaw_decode` turns them back into samples on the device.
Over a mesh of ranks (``parallel/``): the beam front sharded over the data
axis (``update_decoder(backend="sharded", mesh=...)``) and one long
utterance's time axis sharded over it (:meth:`transcribe_long_form`).
While a profiler records, each step of a batch call is a span
(``engine.call`` around ``engine.plan``, ``engine.stage``, ...;
``utils/profiling.py:annotate``, ``docs/torch_architecture.md``).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .audio.dsp import ulaw_encode
from .decode.beam import BeamCTCDecoder
from .decode.beam_auto import AutoBeamDecoder
from .decode.device_beam import DeviceBeamDecoder
from .decode.greedy import GreedyDecoder, collapse_batch
from .decode.lm import coerce_device_lm
from .device import resolve_device as _resolve_device
from .errors import ModelNotInitialized, WrongUsageOfListen
from .features.spectrogram import (
    InferenceSpectrogramAudioParser,
    SpectrogramAudioParser,
)
from .models import deepspeech as ds
from .models import mozilla, streaming
from .ops import gru_cuda, lstm_cuda, persist_plan, precision, rnn_tanh_cuda, walks
from .ops import stft as stft_ops
from .utils.profiling import annotate


class NoLmInstantiatedWarning(Warning):
    pass


def _bucket(n: int, quantum: int) -> int:
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


def _resolve_compute_dtype(compute_dtype: str, device: torch.device) -> str:
    """"auto" means bf16 matmul operands with f32 accumulation on CUDA (the
    recurrent kernels' fast path) and float32 on the CPU. "float32" is
    float32 on either device: on CUDA the recurrent kernels' float32
    variants, the JAX engine's bit-level parity mode with the reference
    stack."""
    if compute_dtype == "auto":
        compute_dtype = "bfloat16" if device.type == "cuda" else "float32"
    if compute_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"unknown compute_dtype: {compute_dtype!r}")
    return compute_dtype


# rho: the time of one step of a 128-row block (two warpgroups on the rows,
# as B3's and B5's walks plan more than 64 rows) over that of a 64-row block,
# the mean of the two walks' ratios on an H100 80GB HBM3 at 700 W
# (chip_smoke.py phases 3 and 3b): B5 as a pair at T = 1000, H = 1024, 12.62
# against 9.20 us a step (1.37); B3's walk at T = 401, H = 1200, D = 2016,
# 16.89 against 11.49 us a step (1.47)
WIDE_BLOCK_STEP = 1.42


def _recurrent_walk(config) -> tuple:
    """(the walk, ``ops/walks.py``, that serving ``config``'s recurrent
    layers launches, its chains a layer): B3 for a bidirectional GRU, B1 for
    a unidirectional one, B5 for the LSTM, B8 for the tanh RNN."""
    chains = 2 if config.bidirectional else 1
    if config.rnn_type == "gru":
        return (gru_cuda.GRU_BIDI_FUSED if chains == 2 else gru_cuda.GRU_SCAN), chains
    if config.rnn_type == "lstm":
        return lstm_cuda.LSTM_SCAN, chains
    return rnn_tanh_cuda.RNN_TANH_SCAN, chains


# the step design's (one launch a step, where no persistent plan fits) step
# of two 64-row blocks over that of one: its grid (csrc/rnn_step.cuh) holds
# ceil(rows / 64) row blocks of every unit slice, launched together each step;
# B5 one chain at H = 2048, T = 1000 on an H100 80GB HBM3 at 700 W
# (chip_smoke.py phase 3c): 137.71 against 112.57 us a step at B = 128 and 64
STEP_TWO_BLOCKS = 137.71 / 112.57

# the mu-law code of a zero sample (0xFF): what pads a staged row's tail
# (code 0 would decode to -32124)
ULAW_ZERO = int(ulaw_encode(np.zeros(1, np.int16))[0])


def ulaw_decode(codes: torch.Tensor) -> torch.Tensor:
    """G.711 mu-law bytes -> float32 samples, on the tensor's device.

    The int32 bit arithmetic of ``audio/dsp.py:ulaw_decode_table``
    (``audioop.ulaw2lin`` parity), elementwise rather than a table gather,
    as the JAX engine decodes."""
    code = (~codes.to(torch.int32)) & 0xFF
    exp = (code >> 4) & 7
    mant = code & 0x0F
    mag = (((mant << 3) + 0x84) << exp) - 0x84
    return torch.where((code & 0x80) != 0, -mag, mag).to(torch.float32)


def _to_host_async(t: torch.Tensor):
    """Start a device-to-host copy without blocking: (host tensor, event),
    the copy into pinned memory and the CUDA event recorded after it, or
    (t, None) for a CPU tensor."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


class DanSpeechRecognizer:
    """Holds the active model + decoder and runs transcription."""

    # waveform lengths are padded up to multiples of this many samples (1 s)
    SAMPLE_BUCKET = 16000
    # rows of one dispatch group; row counts pad to powers of two up to it
    MAX_BATCH_ROWS = 128
    # total bytes of pinned staging buffers kept across calls
    STAGING_CACHE_BYTES = 256 * 1024 * 1024
    # streaming chunk frame counts are padded to multiples of this
    CHUNK_BUCKET = 16

    def __init__(
        self,
        model_name=None,
        lm_name=None,
        alpha: float = 1.3,
        beta: float = 0.2,
        with_gpu: bool = False,  # accepted for API parity; see ``device``
        beam_width: int = 64,
        compute_dtype: str = "auto",
        transfer_format: str = "auto",
        device=None,
    ):
        # "auto": int16 PCM rows stage as they are (float32 otherwise), exact.
        # "ulaw": opt-in and lossy, one byte a sample over the host-device
        # link (G.711 mu-law, audio/dsp.py), decoded on the device by
        # ulaw_decode; the output equals the "auto" path fed mu-law
        # round-tripped audio
        if transfer_format not in ("auto", "ulaw"):
            raise ValueError(f"unknown transfer_format: {transfer_format!r}")
        self.transfer_format = transfer_format
        self.device = _resolve_device(device)
        print(f"Using device: {self.device}")
        self.compute_dtype = _resolve_compute_dtype(compute_dtype, self.device)
        self._compute_params = None
        self._walk_weights = None  # w by padded row count, for the model's walk
        # what the batch scheduler planned, summed over calls
        self.plan_counts = {"calls": 0, "groups": 0, "rows": 0, "padded_row_s": 0.0,
                            "walked_s": 0.0}

        self.model = None
        self.model_name = None
        self.labels = None
        self.audio_config = None
        self.audio_parser = None
        self.lm = None
        self.decoder = None
        self.decoder_backend = "auto"
        self.decoder_mesh = None
        self.long_form_mesh = None  # transcribe_long_form's default, made once
        self.alpha = alpha
        self.beta = beta
        self.beam_width = beam_width

        # pinned host staging buffers, keyed by (shape, dtype)
        self._staging: dict = {}
        self._staging_used: set = set()
        self._window = None

        # streaming state
        self.secondary_model = None
        self._secondary_params = None  # cast and on the device
        self.greedy_decoder = None
        self.string_parts = False
        self._stream_state = None
        self.pipeline_depth = 0
        self._stream_queue: list = []
        self.full_output: list = []
        self.iterating_transcript = ""
        self.spectrograms = []

        if model_name:
            self.update_model(model_name)
        if lm_name:
            if not self.model:
                raise ModelNotInitialized(
                    "Trying to initialize LM without also choosing an acoustic model."
                )
            self.update_decoder(lm_name)

    # ------------------------------------------------------------------
    # Model / decoder lifecycle
    # ------------------------------------------------------------------

    def update_model(self, model) -> None:
        """Swap the acoustic model: its parameters are cast to the compute
        dtype and moved to the engine's device once, here."""
        self.model = model
        self.model_name = model.model_name
        self.audio_config = model.audio_conf
        self.audio_parser = SpectrogramAudioParser(self.audio_config)
        self._window = self.audio_parser.window.to(self.device)
        self.labels = model.labels
        self._compute_params = self._device_params(model)
        self._walk_weights = None
        self.update_decoder(labels=self.labels)

    def _device_params(self, model):
        """The model's parameters cast to the compute dtype, on the device."""
        params = model.params
        if model.config.family == mozilla.FAMILY:
            dtype = torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32
            return ds.params_to(mozilla.compute_params(params, dtype), self.device)
        if self.compute_dtype == "bfloat16":
            params = ds.cast_matmul_weights(params, torch.bfloat16)
        return ds.params_to(params, self.device)

    def update_decoder(self, lm=None, alpha=None, beta=None, labels=None,
                       beam_width=None, backend=None, mesh=None):
        """Decoder hot-swap with change detection.

        ``lm`` is ``"greedy"``, an ``.arpa(.gz)`` / KenLM ``.klm`` path, an
        :class:`~.decode.lm.NgramLM` or a KenLM model. ``None`` keeps a
        value; 0.0 is a real value for ``alpha`` / ``beta``. ``backend``
        selects where the beam search runs when an LM is active (greedy is
        always a device argmax + host collapse):

        - "auto" (default) — :class:`~.decode.beam_auto.AutoBeamDecoder`
          whenever the LM packs into the device hash tables (ARPA, NgramLM,
          trie .klm): the host beam below the crossover batch size, the
          device beam at and above it; else (probing .klm binaries) the
          host beam;
        - "host" — the C++ prefix beam search (native/ctcbeam) with its
          Python oracle fallback;
        - "device" — the beam search on the engine's device with the LM
          tables there (decode/device_beam.py + device_lm.py);
        - "sharded" — the beam front sharded over ``mesh``'s data axis with
          one all_gather a frame (decode/dist_beam.py); ``mesh`` (from
          ``parallel.make_mesh``) is required and remembered across swaps.
        """
        update = False
        if not self.lm and not self.decoder:
            update = True
            self.lm = "greedy"
        if lm and self.lm != lm:
            update = True
            self.lm = lm
        if alpha is not None and self.alpha != alpha:
            update = True
            self.alpha = alpha
        if beta is not None and self.beta != beta:
            update = True
            self.beta = beta
        if labels and labels != self.labels:
            update = True
            self.labels = labels
        if beam_width and beam_width != self.beam_width:
            update = True
            self.beam_width = beam_width
        if backend and backend != self.decoder_backend:
            if backend not in ("auto", "host", "device", "sharded"):
                raise ValueError(f"unknown decoder backend: {backend!r}")
            update = True
            self.decoder_backend = backend
        if mesh is not None and mesh is not self.decoder_mesh:
            update = True
            self.decoder_mesh = mesh
        if update:
            self.decoder = self._build_decoder()

    def _build_decoder(self):
        blank = self.labels.index("_")
        if self.lm == "greedy":
            return GreedyDecoder(labels=self.labels, blank_index=blank)
        backend = self.decoder_backend
        if backend == "auto":
            try:
                device_lm = self._device_lm()
            except ValueError:
                backend = "host"  # probing .klm: cannot be re-keyed
            else:
                return AutoBeamDecoder(
                    labels=self.labels, lm=self.lm, device_lm=device_lm,
                    alpha=self.alpha, beta=self.beta,
                    beam_width=self.beam_width, blank_index=blank,
                    device=self.device,
                )
        if backend == "sharded":
            if self.decoder_mesh is None:
                raise ValueError(
                    "backend='sharded' needs a mesh: "
                    "update_decoder(..., mesh=make_mesh(...))"
                )
            from .decode.dist_beam import ShardedBeamDecoder

            return ShardedBeamDecoder(
                labels=self.labels, mesh=self.decoder_mesh,
                beam_width=self.beam_width, blank_index=blank, lm=self.lm,
                alpha=self.alpha, beta=self.beta,
            )
        if backend == "device":
            return DeviceBeamDecoder(
                labels=self.labels, beam_width=self.beam_width,
                blank_index=blank, lm=self._device_lm(), alpha=self.alpha,
                beta=self.beta, device=self.device,
            )
        return BeamCTCDecoder(
            labels=self.labels, lm_path=self.lm, alpha=self.alpha,
            beta=self.beta, beam_width=self.beam_width, num_processes=6,
            cutoff_prob=1.0, cutoff_top_n=40, blank_index=blank,
        )

    def _device_lm(self):
        """Resolve self.lm to a DeviceLM on the engine's device, or None.

        KenLM probing binaries score through per-order 64-bit tables that
        cannot be re-keyed for the device scheme; those raise ValueError
        (decode/lm.py:coerce_device_lm).
        """
        if self.lm in (None, "greedy"):
            return None
        return coerce_device_lm(self.lm, self.labels, device=self.device)

    # ------------------------------------------------------------------
    # Device program
    # ------------------------------------------------------------------

    def _precision(self):
        """The scope of a device program: full float32 (TF32 off) on CUDA
        in float32 mode, nothing otherwise."""
        return precision.full_float32(self.device, self.compute_dtype == "float32")

    @torch.inference_mode()
    def _forward(self, params, waveforms, lengths, rnn_impl: str = "auto"):
        """(rows, n) int16/float32 waveforms, or uint8 mu-law codes, on the
        device -> ((rows, T', C) probabilities, (rows,) output lengths): the
        forward pass of the model's family."""
        parser = self.audio_parser
        if waveforms.dtype == torch.uint8:
            waveforms = ulaw_decode(waveforms)
        with self._precision():
            if self.model.config.family == mozilla.FAMILY:
                return mozilla.forward(params, waveforms, lengths, rnn_impl=rnn_impl)
            with annotate("model.features"):
                spect, frame_lens = stft_ops.batched_log_spectrogram(
                    waveforms.float(), lengths, parser.n_fft, parser.hop_length,
                    self._window, normalize=parser.normalize,
                )
            return ds.forward(
                params, self.model.config, spect[:, None], frame_lens,
                rnn_impl=rnn_impl,
            )

    @torch.inference_mode()
    def _forward_greedy(self, params, waveforms, lengths):
        """Forward + argmax on the device: only the (rows, T') path ids
        (uint8 while the labels fit) and the lengths cross to the host."""
        probs, out_lens = self._forward(params, waveforms, lengths)
        ids = probs.argmax(dim=-1)
        if probs.shape[-1] <= 256:
            ids = ids.to(torch.uint8)
        return ids, out_lens

    # ------------------------------------------------------------------
    # Bucketed batch scheduler
    # ------------------------------------------------------------------

    @staticmethod
    def _row_quantum(n: int) -> int:
        p = 1
        while p < n:
            p *= 2
        return min(p, DanSpeechRecognizer.MAX_BATCH_ROWS)

    def _walk_weight(self, rows: int) -> float:
        """w of a group padded to ``rows`` rows: one step of the bf16 plan
        (``ops/persist_plan.py``) that the model's recurrent walk takes for
        them, in steps of one 64-row block. The persistent plan's row blocks
        step one after another, a 64-row block (one warpgroup on the rows,
        the two splitting the depth) costing 1 and a 128-row block (a
        warpgroup each 64 rows) WIDE_BLOCK_STEP. The step design (one launch
        a step, where no persistent plan fits) launches the 64-row blocks of
        its grid (``persist_plan.STEP_ROWS``) together each step: one costs
        1, two STEP_TWO_BLOCKS. Either costs twice over where a layer's two
        chains walk one launch after the other. Planned on CUDA
        with the device's SM count and shared memory, elsewhere with an
        H100's; float32 serving is planned the same way."""
        if self._walk_weights is None:
            walk, chains = _recurrent_walk(self.model.config)
            info = (walks.device_info(self.device) if self.device.type == "cuda"
                    else (persist_plan.H100_SMS, persist_plan.H100_SMEM_OPTIN))
            weights = {}
            for q in (1 << k for k in range(self.MAX_BATCH_ROWS.bit_length())):
                planned, apart = walks.plan_of(walk, self.model.config.rnn_hidden_size, q,
                                               chains, info)
                if planned.design == "step":
                    step = 1.0 if q <= persist_plan.STEP_ROWS else STEP_TWO_BLOCKS
                else:
                    per_block = 1.0 if planned.row_groups == 1 else WIDE_BLOCK_STEP
                    step = planned.row_blocks * per_block
                weights[q] = step * (2 if apart else 1)
            self._walk_weights = weights
        return self._walk_weights[rows]

    def _plan_groups(self, recordings: list[np.ndarray]):
        """Group utterance indices into (indices, bucket_len) dispatch plans.

        The recordings, sorted by length, are cut into contiguous groups of
        at most MAX_BATCH_ROWS rows. A group of n rows whose longest lies in
        length bucket L (a SAMPLE_BUCKET multiple) costs

            q * L + GROUP_ROWS * L * w(q),    q = _row_quantum(n):

        its padded volume, which the convolutions, the projections and the
        elementwise passes work through, and its recurrent walk: L steps of
        the plan for q rows, w(q) steps of a 64-row block each
        (:meth:`_walk_weight`). The cut minimises the summed cost, on a tie
        with the fewest groups. A cut that is neither a bucket's end nor a
        power of two rows after the group's start can move right without
        raising the cost, so only those are tried."""
        n = len(recordings)
        order = sorted(range(n), key=lambda i: len(recordings[i]))
        maxlens = [_bucket(len(recordings[i]), self.SAMPLE_BUCKET) for i in order]
        top = self.MAX_BATCH_ROWS
        sizes = [1 << k for k in range(top.bit_length())]  # the row quanta
        # the cost of a group of d rows over its bucket length, and a hair
        # more a group, so that of two plans that cost the same the one with
        # fewer groups is cheaper
        per_quantum = {q: q + persist_plan.GROUP_ROWS * self._walk_weight(q) for q in sizes}
        factor = [0.0] + [per_quantum[1 << (d - 1).bit_length()] for d in range(1, top + 1)]
        hair = 1e-3
        bucket_ends = [j for j in range(1, n + 1) if j == n or maxlens[j] != maxlens[j - 1]]
        # cost[j], start[j]: of the cheapest plan of the first j rows, and
        # the first row of its last group
        cost = [0.0] + [float("inf")] * n
        start = [0] * (n + 1)
        e = 0
        for i in range(n):
            base = cost[i] + hair
            while bucket_ends[e] <= i:
                e += 1
            last = i + top
            for j in [i + q for q in sizes if i + q <= n] + bucket_ends[e : e + top]:
                if j > last:
                    continue
                c = base + factor[j - i] * maxlens[j - 1]
                if c < cost[j]:
                    cost[j], start[j] = c, i
        plans = []
        j = n
        while j > 0:
            i = start[j]
            plans.append((order[i:j], maxlens[j - 1]))
            j = i
        return plans[::-1]

    def _count_plan(self, plans) -> None:
        """Add one call's dispatch plans to :attr:`plan_counts`: the groups,
        the real rows, the padded row-seconds and the seconds walked (each
        group's bucket length: the steps every recurrent layer walks)."""
        rate = self.audio_parser.sampling_rate
        counts = self.plan_counts
        counts["calls"] += 1
        counts["groups"] += len(plans)
        counts["rows"] += sum(len(idxs) for idxs, _ in plans)
        counts["padded_row_s"] += sum(self._row_quantum(len(idxs)) * maxlen
                                      for idxs, maxlen in plans) / rate
        counts["walked_s"] += sum(maxlen for _, maxlen in plans) / rate

    def _staging_buffer(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """A host staging buffer for one dispatch group (pinned when the
        device is CUDA), kept across calls keyed by (shape, dtype). Within
        one call a key is handed out once, since an upload from the first
        may still be in flight; least-recently-used buffers beyond
        STAGING_CACHE_BYTES are dropped."""
        key = (tuple(shape), dtype)
        buf = self._staging.pop(key, None)  # re-insert => LRU order
        if buf is None or key in self._staging_used:
            buf = torch.zeros(shape, dtype=dtype,
                              pin_memory=self.device.type == "cuda")
        self._staging[key] = buf
        self._staging_used.add(key)
        total = sum(b.numel() * b.element_size() for b in self._staging.values())
        for k in list(self._staging):
            if total <= self.STAGING_CACHE_BYTES or k in self._staging_used:
                continue
            b = self._staging.pop(k)
            total -= b.numel() * b.element_size()
        return buf

    def _stage_group(self, recordings, chunk, maxlen):
        """Build the (rows, maxlen) host batch for one dispatch group: rows
        padded to a power of two, int16 when every input is int16 PCM
        (half the upload bytes; the device casts), else float32; uint8
        mu-law codes with ``transfer_format="ulaw"``, float rows rounded to
        int16 first. Pad rows take a real row's length; their outputs are
        dropped."""
        rows = self._row_quantum(len(chunk))
        if self.transfer_format == "ulaw":
            buf = self._staging_buffer((rows, maxlen), torch.uint8)
            batch = buf.numpy()
            lengths = np.empty((rows,), dtype=np.int32)
            for j, i in enumerate(chunk):
                r = recordings[i]
                if r.dtype != np.int16:
                    r = np.clip(np.round(r), -32768, 32767).astype(np.int16)
                batch[j, : len(r)] = ulaw_encode(r)
                batch[j, len(r) :] = ULAW_ZERO
                lengths[j] = len(r)
            batch[len(chunk) :] = ULAW_ZERO  # silent pad rows, as int16's zeros
            lengths[len(chunk) :] = lengths[0]
            return buf, lengths
        int16 = all(recordings[i].dtype == np.int16 for i in chunk)
        buf = self._staging_buffer(
            (rows, maxlen), torch.int16 if int16 else torch.float32
        )
        batch = buf.numpy()
        lengths = np.empty((rows,), dtype=np.int32)
        for j, i in enumerate(chunk):
            r = recordings[i]
            batch[j, : len(r)] = r
            batch[j, len(r) :] = 0
            lengths[j] = len(r)
        lengths[len(chunk) :] = lengths[0]
        return buf, lengths

    def _transcribe_pipelined(self, recordings: list[np.ndarray], show_all: bool):
        if self.model is None:
            raise ModelNotInitialized("No acoustic model loaded")
        with annotate("engine.call"):
            try:
                return self._transcribe_pipelined_inner(recordings, show_all)
            except BaseException:
                # uploads may still read the pinned buffers: drop the cache
                # so the next call cannot overwrite an in-flight source
                self._staging = {}
                self._staging_used = set()
                raise

    @staticmethod
    def _decode_kwargs(decoder, show_all: bool) -> dict:
        """Top-1 serving calls on device decoders backtrack and fetch only
        the best beam. Computed per RESOLVED decoder — the batch-aware auto
        decoder hands different backends to different dispatch groups."""
        if not show_all and getattr(decoder, "supports_n_best", False):
            return {"n_best": 1}
        return {}

    def _transcribe_pipelined_inner(self, recordings, show_all):
        with annotate("engine.plan"):
            plans = self._plan_groups(recordings)
        self._count_plan(plans)
        params = self._compute_params
        greedy = isinstance(self.decoder, GreedyDecoder)
        self._staging_used = set()

        # phase 1: stage, upload and enqueue every group; start the copies
        # of what the host decodes
        pending = []
        for idxs, maxlen in plans:
            with annotate("engine.stage"):
                batch, lengths = self._stage_group(recordings, idxs, maxlen)
            with annotate("engine.upload"):
                wave = batch.to(self.device, non_blocking=True)
                lens = torch.from_numpy(lengths).to(self.device, non_blocking=True)
            with annotate("engine.forward"):
                if greedy:
                    out, out_lens = self._forward_greedy(params, wave, lens)
                else:
                    out, out_lens = self._forward(params, wave, lens)
            decoder, on_device = None, False
            if not greedy:
                decoder = self.decoder
                if hasattr(decoder, "for_batch"):  # batch-aware auto
                    decoder = decoder.for_batch(len(idxs))
                on_device = getattr(decoder, "supports_n_best", False)
            with annotate("engine.d2h"):
                if not on_device:
                    # the argmax paths, or the probabilities of the real rows
                    # for the host beam (pad rows would cost real beam work)
                    out, _ = _to_host_async(out if greedy else out[: len(idxs)])
                host_lens, done = _to_host_async(out_lens)
            pending.append((idxs, decoder, on_device, out, host_lens, done))

        # phase 2: decode in dispatch order while later groups run
        results: list = [None] * len(recordings)
        blank = self.decoder.blank_index
        for idxs, decoder, on_device, out, host_lens, done in pending:
            if done is not None:
                with annotate("engine.wait"):
                    done.synchronize()
            lens_np = host_lens.numpy()
            if decoder is None:
                with annotate("engine.collapse"):
                    strings = collapse_batch(
                        out.numpy()[: len(idxs)], lens_np[: len(idxs)],
                        self.labels, blank,
                    )
                decoded = [[s] for s in strings]
            else:
                with annotate("engine.decode"):
                    if on_device:
                        # device beam: the probabilities never leave the
                        # device; the pad rows ride the search and are
                        # dropped below
                        decoded, _ = decoder.decode(
                            out, lens_np, **self._decode_kwargs(decoder, show_all)
                        )
                    else:
                        decoded, _ = decoder.decode(out.numpy(), lens_np[: len(idxs)])
            for j, i in enumerate(idxs):
                results[i] = decoded[j]
        return results

    def transcribe(self, recording, show_all: bool = False):
        """One-shot transcription of a waveform."""
        decoded_output = self._transcribe_pipelined([np.asarray(recording)], show_all)
        if show_all:
            if self.lm == "greedy":
                warnings.warn(
                    "You are trying to get all beams but no LM has been instantiated.",
                    NoLmInstantiatedWarning,
                )
            return decoded_output[0]
        return decoded_output[0][0]

    def transcribe_batch(self, recordings: list, show_all: bool = False) -> list:
        """Batch transcription through the bucketed scheduler."""
        decoded_output = self._transcribe_pipelined(
            [np.asarray(r) for r in recordings], show_all
        )
        if show_all:
            return decoded_output
        return [d[0] for d in decoded_output]

    def transcribe_long_form(self, recording, mesh=None) -> str:
        """Transcribe one long utterance with its time axis sharded over
        ``mesh``'s data axis (parallel/time_shard.py: halo-exchanged convs,
        the wavefront of ``gru_scan`` launches for unidirectional models,
        the two-direction ring of ``gru_scan`` / ``gru_scan_bidi`` launches
        for bidirectional ones), decoded by the engine's decoder.
        ``mesh=None`` uses one that ``parallel.make_mesh`` builds on the
        engine's device at the first such call (a group of this process
        alone when no launcher started it) and the engine keeps."""
        if self.model is None:
            raise ModelNotInitialized("No acoustic model loaded")
        if self.model.config.family != "ds2":
            raise ValueError("the long form serves DeepSpeech2 models only")
        from .parallel.mesh import make_mesh
        from .parallel.time_shard import transcribe_long_form

        if mesh is None:
            if self.long_form_mesh is None:
                self.long_form_mesh = make_mesh(device=self.device)
            mesh = self.long_form_mesh
        held = self._compute_params["fc"].weight.device
        params = self._compute_params if held == mesh.device else None
        with self._precision():
            return transcribe_long_form(self.model, np.asarray(recording), mesh,
                                        decoder=self.decoder, params=params)

    # ------------------------------------------------------------------
    # Streaming
    # ------------------------------------------------------------------

    def enable_streaming(self, secondary_model=None, return_string_parts=True,
                         pipeline_depth: int = 0):
        """Enter streaming mode.

        ``pipeline_depth`` > 0 enables the pipelined mode: chunk k's device
        step is enqueued at once, but its partial transcript is returned
        ``pipeline_depth`` chunks later, so up to that many result copies
        are in flight while the host parses later chunks. Final results
        equal depth 0; only the cadence of the partials shifts.
        """
        if self.model is not None:
            streaming.require_gru(self.model.config)
        self.full_output = []
        self.iterating_transcript = ""
        self.secondary_model = secondary_model
        # cast and upload now, not on the latency path of the final chunk
        self._secondary_params = (
            None if secondary_model is None else self._device_params(secondary_model)
        )
        self.spectrograms = []
        self.greedy_decoder = GreedyDecoder(
            labels=self.labels, blank_index=self.labels.index("_")
        )
        self.audio_parser = InferenceSpectrogramAudioParser(
            audio_config=self.audio_config
        )
        self.string_parts = bool(return_string_parts)
        self._stream_state = None
        self.pipeline_depth = int(pipeline_depth)
        self._stream_queue = []

    def disable_streaming(self, keep_secondary_model=False):
        self.audio_parser = SpectrogramAudioParser(self.audio_config)
        self.greedy_decoder = None
        self.reset_streaming_params()
        self.string_parts = False
        if not keep_secondary_model:
            self.secondary_model = None
            self._secondary_params = None

    def reset_streaming_params(self):
        self.iterating_transcript = ""
        self.full_output = []
        self.spectrograms = []
        self._stream_state = None
        self._stream_queue = []

    def _stream_input(self, spect) -> tuple[torch.Tensor, int]:
        """A (F, t) host spectrogram -> ((1, 1, F, Tp) chunk on the device,
        zero-padded to a CHUNK_BUCKET multiple with CHUNK_HEADROOM spare
        columns, t)."""
        spect = np.asarray(spect, dtype=np.float32)
        t_chunk = spect.shape[1]
        t_padded = _bucket(t_chunk + streaming.CHUNK_HEADROOM, self.CHUNK_BUCKET)
        chunk = np.zeros((spect.shape[0], t_padded), np.float32)
        chunk[:, :t_chunk] = spect
        x = torch.from_numpy(chunk)[None, None].to(self.device)
        return x, t_chunk

    def _new_stream_state(self, width: int) -> streaming.StreamStateM:
        """Masked streaming state on the device, its lookahead buffer sized
        for a first chunk of ``width`` padded columns."""
        buf_cap = _bucket(streaming.phys_rnn_frames(width, is_first=True), 16)
        return streaming.init_stream_state_masked(
            self.model.config, buf_cap=buf_cap, device=self.device
        )

    def streaming_transcribe(self, recording, is_last: bool, is_first: bool):
        """Chunked streaming transcription state machine.

        Greedy partials per chunk; on the final chunk, either a secondary
        model re-transcribes the concatenated spectrograms, or the LM
        decoder re-decodes the concatenated probability stream.
        """
        spect = self.audio_parser.parse_audio(recording, is_last)
        out = ""
        if len(spect) != 0 and is_first and spect.shape[1] < 5:
            # the conv left-context cache is 10 columns; a first chunk of
            # fewer than 5 spectrogram frames cannot fill it and would
            # corrupt every later chunk
            raise WrongUsageOfListen(
                f"first streaming chunk yields {spect.shape[1]} spectrogram "
                "frames; at least 5 (~0.1 s of audio) are required; use "
                "Recognizer.real_time_streaming, which sizes chunks "
                "correctly"
            )
        if len(spect) != 0:
            if self.secondary_model is not None:
                self.spectrograms.append(np.asarray(spect))
            chunk, t_chunk = self._stream_input(spect)
            if self._stream_state is None:
                self._stream_state = self._new_stream_state(chunk.shape[-1])
            with self._precision():
                probs, out_len, self._stream_state = streaming.streaming_step_masked(
                    self._compute_params, self.model.config, chunk, t_chunk,
                    self._stream_state, is_first, is_last,
                )

            if is_first:
                return ""

            result = _to_host_async(probs[:, :out_len])
            if self.pipeline_depth and not is_last:
                # pipelined mode: return the partial of the chunk that fell
                # off the window
                self._stream_queue.append(result)
                if len(self._stream_queue) > self.pipeline_depth:
                    out = self._absorb_stream_result(*self._stream_queue.pop(0))
            else:
                # sync mode (and the final chunk of pipelined mode): drain
                # anything still in flight, then this chunk
                for queued in self._stream_queue:
                    self._absorb_stream_result(*queued)
                self._stream_queue = []
                out = self._absorb_stream_result(*result)

        if is_last:
            # drain results still in flight even when this final chunk
            # produced no frames (shorter than n_fft)
            for queued in self._stream_queue:
                self._absorb_stream_result(*queued)
            self._stream_queue = []
            if len(self.iterating_transcript) > 1:
                if self.secondary_model is not None:
                    final = np.concatenate(self.spectrograms, axis=1)
                    self.spectrograms = []
                    probs, out_lens = self._run_secondary(final)
                    if not getattr(self.decoder, "supports_n_best", False):
                        probs = probs.cpu()  # a host decoder
                    decoded_out, _ = self.decoder.decode(probs, out_lens)
                    self.reset_streaming_params()
                    return decoded_out[0][0]
                if self.lm != "greedy":
                    final_out = np.concatenate(self.full_output, axis=1)
                    decoded_out, _ = self.decoder.decode(
                        final_out, np.array([final_out.shape[1]])
                    )
                    self.reset_streaming_params()
                    return decoded_out[0][0]
                out = self.iterating_transcript
                self.reset_streaming_params()
                return out
            return ""

        return out

    def _absorb_stream_result(self, probs, done) -> str:
        """Wait for one chunk's probabilities to reach the host, keep them
        for the final LM re-decode, fold its greedy partial into the running
        transcript (joining a repeated character across the chunk boundary)
        and return the per-chunk output string."""
        if done is not None:
            done.synchronize()
        probs = probs.numpy()
        self.full_output.append(probs)
        decoded_out, _ = self.greedy_decoder.decode(probs)
        transcript = decoded_out[0][0]

        if (
            self.iterating_transcript
            and transcript
            and self.iterating_transcript[-1] == transcript[0]
        ):
            self.iterating_transcript += transcript[1:]
            transcript = transcript[1:]
        else:
            self.iterating_transcript += transcript

        return transcript if self.string_parts else self.iterating_transcript

    @torch.inference_mode()
    def _run_secondary(self, spect: np.ndarray):
        """Run the secondary model over the accumulated (F, T) spectrogram,
        on its own parameters cast to the compute dtype (a bidirectional
        secondary model runs the ``gru_bidi_fused`` kernel on CUDA)."""
        x = torch.from_numpy(np.ascontiguousarray(spect))[None, None].to(self.device)
        lengths = torch.tensor([spect.shape[1]], dtype=torch.int32, device=self.device)
        with self._precision():
            probs, out_lens = ds.forward(
                self._secondary_params, self.secondary_model.config, x, lengths
            )
        return probs, out_lens.cpu()
