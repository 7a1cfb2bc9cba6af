"""Cohort-batched streaming: S concurrent real-time sessions, one chunk step.

The port of ``danspeech_tpu/multistream.py``. A single stream's chunk step
multiplies a (1, H) row by each layer's (H, 3H) recurrent weights at every
frame and pays one device round trip per chunk. ``MultiStreamTranscriber``
steps S streams in lockstep through one chunk step whose batch dimension is
the stream index: each product becomes (S, H) x (H, 3H) (the ``gru_scan``
kernel at B = S, with the state carried from the last chunk), and the round
trip is paid once per cohort.

Cohort semantics: all streams advance together with the same chunk sample
count per step and shared is_first / is_last flags, the shape of a serving
front end that groups fixed-cadence sessions into cohorts and refills a
closing session's slot at the next epoch. Per stream (adaptive feature
normalisation, greedy partials, the repeated-character join at chunk
boundaries, the <= 1-character gate on finals, the optional LM final
re-decode) the result is that of S independent
``DanSpeechRecognizer.streaming_transcribe`` streams.
"""

from __future__ import annotations

import numpy as np
import torch

from .decode.greedy import GreedyDecoder
from .device import resolve_device
from .engine import _bucket, _resolve_compute_dtype, _to_host_async
from .features.spectrogram import InferenceSpectrogramAudioParser
from .models import deepspeech as ds
from .models import streaming


class MultiStreamTranscriber:
    """Serve ``n_streams`` concurrent chunked-audio sessions in lockstep.

    Parameters
    ----------
    model:
        A streaming (unidirectional GRU + lookahead, 2-conv)
        ``DeepSpeechModel``; LSTM and tanh-RNN models raise
        ``NotImplementedError``, as single-stream streaming does.
    n_streams:
        Cohort size S. Each :meth:`step` call takes exactly S chunks.
    final_decoder:
        Optional decoder (a ``BeamCTCDecoder``, ``DeviceBeamDecoder`` or
        ``AutoBeamDecoder``) applied per stream to the concatenated
        probability stream on the final chunk. ``None`` keeps the
        accumulated greedy transcript.
    compute_dtype:
        "auto" is bf16 on CUDA and float32 on the CPU; float32 on CUDA is
        refused (the recurrent kernels take bf16 only).
    device:
        ``None`` means CUDA (raising without a GPU); ``"cpu"`` the CPU.
    rnn_impl:
        "auto" runs the recurrence on the ``gru_scan`` kernel for CUDA
        tensors; "plain" on its plain PyTorch version (for comparisons).
    """

    CHUNK_BUCKET = 16

    def __init__(self, model, n_streams: int, final_decoder=None,
                 compute_dtype: str = "auto", device=None, rnn_impl: str = "auto"):
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        streaming.require_gru(model.config)
        self.device = resolve_device(device)
        self.compute_dtype = _resolve_compute_dtype(compute_dtype, self.device)
        self.model = model
        self.n_streams = n_streams
        self.labels = model.labels
        self.rnn_impl = rnn_impl
        # cast and moved once, here
        params = model.params
        if self.compute_dtype == "bfloat16":
            params = ds.cast_matmul_weights(params, torch.bfloat16)
        self._compute_params = ds.params_to(params, self.device)
        self.greedy_decoder = GreedyDecoder(
            labels=self.labels, blank_index=self.labels.index("_")
        )
        self.final_decoder = final_decoder
        self.reset()

    def reset(self) -> None:
        """Start a new stream epoch for every slot in the cohort."""
        self.parsers = [
            InferenceSpectrogramAudioParser(audio_config=self.model.audio_conf)
            for _ in range(self.n_streams)
        ]
        self.transcripts = [""] * self.n_streams
        self.full_output: list[np.ndarray] = []
        self._state = None

    def step(self, chunks, is_last: bool, is_first: bool) -> list[str]:
        """Advance every stream by one chunk.

        ``chunks`` is a sequence of ``n_streams`` waveform chunks with the
        same sample count (a lockstep cohort). Returns the per-stream
        partial transcripts (the new text this chunk contributed), or, when
        ``is_last``, the per-stream final transcripts.
        """
        if len(chunks) != self.n_streams:
            raise ValueError(
                f"expected {self.n_streams} chunks, got {len(chunks)}"
            )
        lens = {len(c) for c in chunks}
        if len(lens) != 1:
            raise ValueError(
                "cohort chunks must share one sample count per step "
                f"(got lengths {sorted(lens)})"
            )

        # the host parses each stream's spectrogram (numpy rFFT), one at a time
        spects = [
            p.parse_audio(np.asarray(c, dtype=np.float32), is_last)
            for p, c in zip(self.parsers, chunks)
        ]
        partials = [""] * self.n_streams

        if len(spects[0]) != 0:
            spect = np.stack(
                [np.asarray(s, dtype=np.float32) for s in spects]
            )  # (S, F, T): one T for every stream of a lockstep cohort
            t_chunk = spect.shape[2]
            t_padded = _bucket(
                t_chunk + streaming.CHUNK_HEADROOM, self.CHUNK_BUCKET
            )
            batch = np.zeros(
                (self.n_streams, 1, spect.shape[1], t_padded), np.float32
            )
            batch[:, 0, :, :t_chunk] = spect

            if self._state is None:
                buf_cap = _bucket(
                    streaming.phys_rnn_frames(t_padded, is_first=True), 16
                )
                self._state = streaming.init_stream_state_masked(
                    self.model.config, buf_cap=buf_cap, batch=self.n_streams,
                    device=self.device,
                )

            probs, out_len, self._state = streaming.streaming_step_masked(
                self._compute_params, self.model.config,
                torch.from_numpy(batch).to(self.device), t_chunk, self._state,
                is_first, is_last, rnn_impl=self.rnn_impl,
            )

            if not is_first:
                # one synchronising pinned copy for the whole cohort
                probs, done = _to_host_async(probs[:, :out_len])
                if done is not None:
                    done.synchronize()
                probs = probs.numpy()
                if self.final_decoder is not None:
                    self.full_output.append(probs)
                decoded, _ = self.greedy_decoder.decode(probs)
                for s in range(self.n_streams):
                    text = decoded[s][0]
                    # join a character repeated across the chunk boundary,
                    # per stream
                    if (
                        self.transcripts[s]
                        and text
                        and self.transcripts[s][-1] == text[0]
                    ):
                        text = text[1:]
                    self.transcripts[s] += text
                    partials[s] = text

        if is_last:
            finals = self._finalize()
            self.reset()
            return finals
        return partials

    def _finalize(self) -> list[str]:
        # a stream whose transcript has <= 1 character ends with "", and only
        # the streams past that gate take the LM re-decode
        finals = [t if len(t) > 1 else "" for t in self.transcripts]
        if self.final_decoder is not None and self.full_output:
            cat = np.concatenate(self.full_output, axis=1)  # (S, T_tot, C)
            sizes = np.full((self.n_streams,), cat.shape[1], dtype=np.int32)
            decoded, _ = self.final_decoder.decode(cat, sizes)
            for s in range(self.n_streams):
                if len(self.transcripts[s]) > 1:
                    finals[s] = decoded[s][0]
        return finals
