"""Inference engine: model/decoder lifecycle, batch and streaming
transcription.

The port of the batch and streaming paths of ``danspeech_tpu/engine.py``.
Batch: the device program (int16/float32 waveforms -> spectrogram -> conv
-> RNN stack -> head -> softmax, and the argmax when the decoder is greedy)
runs on the engine's device; waveforms are grouped by length bucket into
dispatch groups of at most 128 rows, every group is staged in pinned host
memory, uploaded and enqueued before the host decodes the first group, so
host decoding overlaps the device work of later groups. With a language
model each group's decoder is resolved by its row count: the device beam
search reads the probabilities where they are, the host beam gets them
through a pinned asynchronous copy with the pad rows sliced off.
Streaming: the host parses each chunk's spectrogram, pads it to a
CHUNK_BUCKET multiple and runs the masked chunk step
(``models/streaming.py``) on state kept on the device; greedy partials per
chunk, and on the final chunk either a secondary model re-transcribes the
whole stream or the LM decoder re-decodes the stream's probabilities.

The device is CUDA unless the caller passes ``device="cpu"``. With
``transfer_format="ulaw"`` the rows cross as G.711 mu-law bytes, one a
sample, and :func:`ulaw_decode` turns them back into samples on the device.
The sharded beam and long-form transcription come with the parallelism
slice.
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
from .models import streaming
from .ops import stft as stft_ops


class NoLmInstantiatedWarning(Warning):
    pass


def _bucket(n: int, quantum: int) -> int:
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


def _resolve_compute_dtype(compute_dtype: str, device: torch.device) -> str:
    """"auto" means bf16 matmul operands with f32 accumulation on CUDA (the
    recurrent kernels' dtype) and float32 on the CPU. Those kernels take bf16
    only, so float32 on CUDA is refused here rather than failing inside a
    kernel wrapper at the first transcription (ROADMAP A6b)."""
    if compute_dtype == "auto":
        compute_dtype = "bfloat16" if device.type == "cuda" else "float32"
    if compute_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"unknown compute_dtype: {compute_dtype!r}")
    if compute_dtype == "float32" and device.type == "cuda":
        raise ValueError(
            "compute_dtype='float32' is not available on CUDA: the recurrent "
            "kernels take bf16 only (ROADMAP A6b); use 'bfloat16' on the "
            "card or device='cpu' for float32"
        )
    return compute_dtype


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
    # merging two adjacent length buckets into one dispatch may inflate the
    # padded sample volume (rows x bucket length) by at most this factor
    MERGE_INFLATION = 1.6
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

        self.model = None
        self.model_name = None
        self.labels = None
        self.audio_config = None
        self.audio_parser = None
        self.lm = None
        self.decoder = None
        self.decoder_backend = "auto"
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
        self.update_decoder(labels=self.labels)

    def _device_params(self, model):
        """The model's parameters cast to the compute dtype, on the device."""
        params = model.params
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
          tables there (decode/device_beam.py + device_lm.py).

        "sharded" and ``mesh`` raise: the sharded beam comes with the
        parallelism slice (ROADMAP A13).
        """
        if mesh is not None or backend == "sharded":
            raise NotImplementedError(
                "the sharded beam decoder and mesh= come with the parallelism "
                "slice (ROADMAP A13)"
            )
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
            if backend not in ("auto", "host", "device"):
                raise ValueError(f"unknown decoder backend: {backend!r}")
            update = True
            self.decoder_backend = backend
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

    @torch.inference_mode()
    def _forward(self, params, waveforms, lengths, rnn_impl: str = "auto"):
        """(rows, n) int16/float32 waveforms, or uint8 mu-law codes, on the
        device -> ((rows, T', C) probabilities, (rows,) output lengths)."""
        parser = self.audio_parser
        if waveforms.dtype == torch.uint8:
            waveforms = ulaw_decode(waveforms)
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

    def _plan_groups(self, recordings: list[np.ndarray]):
        """Group utterance indices into (indices, bucket_len) dispatch
        plans: one length bucket per SAMPLE_BUCKET quantum, at most
        MAX_BATCH_ROWS rows per plan, then adjacent under-filled buckets
        merged while the padded volume stays within MERGE_INFLATION of the
        sum of the merged plans' own volumes."""
        buckets: dict[int, list[int]] = {}
        for i, r in enumerate(recordings):
            b = _bucket(len(r), self.SAMPLE_BUCKET)
            buckets.setdefault(b, []).append(i)
        plans = []
        for maxlen in sorted(buckets):
            idxs = buckets[maxlen]
            for s in range(0, len(idxs), self.MAX_BATCH_ROWS):
                plans.append((idxs[s : s + self.MAX_BATCH_ROWS], maxlen))

        def cost(idxs, maxlen):
            return self._row_quantum(len(idxs)) * maxlen

        merged: list[tuple[list[int], int, int]] = []  # (idxs, maxlen, orig)
        for idxs, maxlen in plans:  # ascending maxlen
            own = cost(idxs, maxlen)
            if merged:
                prev_idxs, _, prev_orig = merged[-1]
                if len(prev_idxs) + len(idxs) <= self.MAX_BATCH_ROWS:
                    joint = cost(prev_idxs + idxs, maxlen)
                    if joint <= self.MERGE_INFLATION * (prev_orig + own):
                        merged[-1] = (prev_idxs + idxs, maxlen, prev_orig + own)
                        continue
            merged.append((list(idxs), maxlen, own))
        return [(idxs, maxlen) for idxs, maxlen, _ in merged]

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
        try:
            return self._transcribe_pipelined_inner(recordings, show_all)
        except BaseException:
            # uploads may still read the pinned buffers: drop the cache so
            # the next call cannot overwrite an in-flight source
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
        plans = self._plan_groups(recordings)
        params = self._compute_params
        greedy = isinstance(self.decoder, GreedyDecoder)
        self._staging_used = set()

        # phase 1: stage, upload and enqueue every group; start the copies
        # of what the host decodes
        pending = []
        for idxs, maxlen in plans:
            batch, lengths = self._stage_group(recordings, idxs, maxlen)
            wave = batch.to(self.device, non_blocking=True)
            lens = torch.from_numpy(lengths).to(self.device, non_blocking=True)
            decoder, on_device = None, False
            if greedy:
                out, out_lens = self._forward_greedy(params, wave, lens)
            else:
                out, out_lens = self._forward(params, wave, lens)
                decoder = self.decoder
                if hasattr(decoder, "for_batch"):  # batch-aware auto
                    decoder = decoder.for_batch(len(idxs))
                on_device = getattr(decoder, "supports_n_best", False)
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
                done.synchronize()
            lens_np = host_lens.numpy()
            if decoder is None:
                strings = collapse_batch(
                    out.numpy()[: len(idxs)], lens_np[: len(idxs)],
                    self.labels, blank,
                )
                decoded = [[s] for s in strings]
            elif on_device:
                # device beam: the probabilities never leave the device;
                # the pad rows ride the search and are dropped below
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
        probs, out_lens = ds.forward(
            self._secondary_params, self.secondary_model.config, x, lengths
        )
        return probs, out_lens.cpu()
