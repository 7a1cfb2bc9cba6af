"""Public Recognizer API: batch recognition, VAD listen loops and
real-time streaming.

The port of ``danspeech_tpu/recognizer.py``: the same constructor, tuning
attributes, ``recognize`` / ``recognize_batch`` / ``update_model`` /
``update_decoder`` (greedy or an LM-fused beam on the host or the device),
the blocking energy-endpointed ``listen``, the streaming listener
(``listen_stream``, ``listen_in_background``, whose chunks pass through a
thread-safe queue), silence-segmented ``streaming``, real-time chunked
streaming (``enable_real_time_streaming`` / ``real_time_streaming``) and
the microphone calibrations (``adjust_for_speech``,
``adjust_for_ambient_noise``, ``update_stream_parameters``).
``recognize_long_form`` rides the parallelism slice (ROADMAP A13) and
raises until then.
"""

from __future__ import annotations

import collections
import math
import queue
import threading
import time

import numpy as np

from .audio.dsp import rms
from .audio.io import AudioData, SpeechSource
from .engine import DanSpeechRecognizer
from .errors import (
    ModelNotInitialized,
    NoDataInBuffer,
    WaitTimeoutError,
    WrongUsageOfListen,
)


class Recognizer:
    """A collection of speech-recognition functionality.

    Construct with an optional model; keyword arguments go to
    :class:`DanSpeechRecognizer` (``device=None`` means CUDA,
    ``device="cpu"`` the CPU).
    """

    def __init__(self, model=None, lm=None, with_gpu=False, **kwargs):
        # VAD / endpointing tuning (the original defaults)
        self.energy_threshold = 1000
        self.pause_threshold = 0.8
        self.phrase_threshold = 0.3
        self.non_speaking_duration = 0.35
        self.mininum_required_speaking_seconds = 0.7
        self.dynamic_energy_threshold = True
        self.dynamic_energy_adjustment_damping = 0.15
        self.dynamic_energy_ratio = 1.5

        self.danspeech_recognizer = DanSpeechRecognizer(with_gpu=with_gpu, **kwargs)

        self.stream = False
        self.stream_thread_stopper = None

        if model:
            self.update_model(model)
        if lm:
            if not model:
                raise ModelNotInitialized(
                    "Trying to initialize language model without also choosing an "
                    "acoustic model."
                )
            self.update_decoder(lm=lm)

        self.microphone = None

    def recognize(self, audio_data, show_all: bool = False):
        """Transcribe one waveform."""
        return self.danspeech_recognizer.transcribe(audio_data, show_all=show_all)

    def recognize_batch(self, audio_batch, show_all: bool = False):
        """Transcribe a list of waveforms in bucketed device batches."""
        return self.danspeech_recognizer.transcribe_batch(
            audio_batch, show_all=show_all
        )

    def update_model(self, model) -> None:
        self.danspeech_recognizer.update_model(model)
        print(f"Model updated to: {model.model_name}")

    def update_decoder(self, lm=None, alpha=None, beta=None, beam_width=None,
                       backend=None, mesh=None):
        """Swap the decoder. ``lm`` is ``"greedy"``, an ARPA / KenLM path or
        an n-gram model; ``backend`` selects where the beam search runs:
        "auto" (by batch size), "host" (C++) or "device" (the engine's
        device). ``"sharded"`` and ``mesh`` raise until the parallelism
        slice (ROADMAP A13)."""
        self.danspeech_recognizer.update_decoder(
            lm=lm, alpha=alpha, beta=beta, beam_width=beam_width,
            backend=backend, mesh=mesh,
        )

    def recognize_long_form(self, audio_data, mesh=None):
        """Transcribe one long utterance with its time axis sharded over
        devices: not ported yet."""
        raise NotImplementedError(
            "recognize_long_form rides the time-sharded forward of the "
            "parallelism slice (ROADMAP A13)"
        )

    # ------------------------------------------------------------------
    # Blocking listen
    # ------------------------------------------------------------------

    def listen(self, source, timeout=None, phrase_time_limit=None) -> AudioData:
        """Block until one energy-endpointed phrase is captured."""
        assert isinstance(source, SpeechSource), "Source must be an audio source"
        assert source.stream is not None, (
            "Audio source must be entered before listening: use it inside a "
            "``with`` statement"
        )
        assert self.pause_threshold >= self.non_speaking_duration >= 0

        seconds_per_buffer = float(source.chunk) / source.sampling_rate
        pause_buffer_count = int(math.ceil(self.pause_threshold / seconds_per_buffer))
        phrase_buffer_count = int(math.ceil(self.phrase_threshold / seconds_per_buffer))
        non_speaking_buffer_count = int(
            math.ceil(self.non_speaking_duration / seconds_per_buffer)
        )

        elapsed_time = 0.0
        while True:
            frames = collections.deque()

            # wait for the phrase to start
            while True:
                elapsed_time += seconds_per_buffer
                if timeout and elapsed_time > timeout:
                    raise WaitTimeoutError(
                        "listening timed out while waiting for phrase to start"
                    )
                buffer = source.stream.read(source.chunk)
                if len(buffer) == 0:
                    break
                frames.append(buffer)
                if len(frames) > non_speaking_buffer_count:
                    frames.popleft()

                energy = rms(buffer, source.sampling_width)
                if energy > self.energy_threshold:
                    break

                if self.dynamic_energy_threshold:
                    damping = (
                        self.dynamic_energy_adjustment_damping ** seconds_per_buffer
                    )
                    target_energy = energy * self.dynamic_energy_ratio
                    self.energy_threshold = (
                        self.energy_threshold * damping
                        + target_energy * (1 - damping)
                    )

            # capture until the phrase ends
            pause_count, phrase_count = 0, 0
            phrase_start_time = elapsed_time
            while True:
                elapsed_time += seconds_per_buffer
                if (
                    phrase_time_limit
                    and elapsed_time - phrase_start_time > phrase_time_limit
                ):
                    break
                buffer = source.stream.read(source.chunk)
                if len(buffer) == 0:
                    break
                frames.append(buffer)
                phrase_count += 1

                energy = rms(buffer, source.sampling_width)
                if energy > self.energy_threshold:
                    pause_count = 0
                else:
                    pause_count += 1
                if pause_count > pause_buffer_count:
                    break

            phrase_count -= pause_count
            if phrase_count >= phrase_buffer_count or len(buffer) == 0:
                break

        for _ in range(pause_count - non_speaking_buffer_count):
            frames.pop()
        frame_data = b"".join(frames)
        return AudioData(frame_data, source.sampling_rate, source.sampling_width)

    # ------------------------------------------------------------------
    # Streaming listener
    # ------------------------------------------------------------------

    def listen_stream(self, source, timeout=None, phrase_time_limit=None):
        """Yield (is_last, frames) chunks between detected silences."""
        assert isinstance(source, SpeechSource), "Source must be an audio source"
        assert source.stream is not None
        assert self.pause_threshold >= self.non_speaking_duration >= 0

        seconds_per_buffer = float(source.chunk) / source.sampling_rate
        pause_buffer_count = int(math.ceil(self.pause_threshold / seconds_per_buffer))
        phrase_buffer_count = int(math.ceil(self.phrase_threshold / seconds_per_buffer))
        non_speaking_buffer_count = int(
            math.ceil(self.non_speaking_duration / seconds_per_buffer)
        )

        elapsed_time = 0.0
        buffer = []
        while self.stream:
            frames = []

            while self.stream:
                elapsed_time += seconds_per_buffer
                if timeout and elapsed_time > timeout:
                    raise WaitTimeoutError(
                        "listening timed out while waiting for phrase to start"
                    )
                buffer = source.stream.read(source.chunk)
                if len(buffer) == 0:
                    break
                frames.append(buffer)
                if len(frames) > non_speaking_buffer_count:
                    frames.pop(0)

                energy = rms(buffer, source.sampling_width)
                if energy > self.energy_threshold:
                    break

            if not self.stream:
                yield False, []

            # leading silence context
            yield False, frames

            pause_count, phrase_count = 0, 0
            phrase_start_time = elapsed_time
            while True:
                buffer = source.stream.read(source.chunk)
                if len(buffer) == 0:
                    break
                elapsed_time += seconds_per_buffer
                if (
                    phrase_time_limit
                    and elapsed_time - phrase_start_time > phrase_time_limit
                ):
                    break
                phrase_count += 1

                energy = rms(buffer, source.sampling_width)
                if energy > self.energy_threshold:
                    pause_count = 0
                else:
                    pause_count += 1
                if pause_count > pause_buffer_count:
                    break

                yield False, buffer

            phrase_count -= pause_count
            if phrase_count >= phrase_buffer_count or len(buffer) == 0:
                break

        if len(buffer) == 0:
            yield True, []
        else:
            yield True, buffer

        raise WrongUsageOfListen(
            "Wrong usage of stream. Create a new listen generator: this instance "
            "has completed a full listen."
        )

    @staticmethod
    def get_audio_data(frames, source) -> np.ndarray:
        """Bytes frames -> float waveform array."""
        frame_data = b"".join(frames)
        return AudioData(
            frame_data, source.sampling_rate, source.sampling_width
        ).get_array_data()

    def listen_in_background(self, source):
        """Spawn a daemon listener thread; returns (stopper, get_data).
        Chunks pass through a queue; ``get_data`` raises NoDataInBuffer
        when it is empty."""
        assert isinstance(source, SpeechSource), "Source must be an audio source"

        running = [True]
        data: queue.Queue = queue.Queue()

        def threaded_listen():
            with source as s:
                while running[0]:
                    generator = self.listen_stream(s)
                    try:
                        while True:
                            is_last_, temp = next(generator)
                            if isinstance(temp, list):
                                arr = self.get_audio_data(temp, source)
                            else:
                                arr = self.get_audio_data([temp], source)
                            data.put((is_last_, arr))
                            if is_last_:
                                break
                    except WaitTimeoutError:
                        pass

        def stopper(wait_for_stop=True):
            running[0] = False
            if wait_for_stop:
                listener_thread.join()

        def get_data():
            try:
                return data.get_nowait()
            except queue.Empty:
                raise NoDataInBuffer from None

        listener_thread = threading.Thread(target=threaded_listen, daemon=True)
        listener_thread.start()
        return stopper, get_data

    # ------------------------------------------------------------------
    # Silence-segmented streaming
    # ------------------------------------------------------------------

    def enable_streaming(self):
        if self.stream:
            print("Streaming already enabled...")
        else:
            self.stream = True

    def disable_streaming(self):
        """Stop a silence-segmented stream. As in the JAX package (and the
        original), on a recognizer that is not streaming this *enables*
        streaming instead (ROADMAP C17); a stream whose listener never
        started stops without calling a stopper."""
        if self.stream:
            self.stream = False
            if self.stream_thread_stopper is not None:  # a listener was started
                self.stream_thread_stopper(wait_for_stop=False)
        else:
            self.stream = True

    def streaming(self, source):
        """Generator: one transcript per phrase between detected silences
        of ``source``, each ``recognize`` of the phrase's samples; phrases no
        longer than ``mininum_required_speaking_seconds`` are skipped."""
        stopper, data_getter = self.listen_in_background(source)
        self.stream_thread_stopper = stopper

        is_last = False
        is_first_data = False
        data_array = []

        while self.stream:
            while True:
                if is_last:
                    is_first_data = True
                    break
                try:
                    if is_first_data:
                        is_last, data_array = data_getter()
                        is_first_data = False
                    else:
                        is_last, temp = data_getter()
                        data_array = np.concatenate((data_array, temp))
                except NoDataInBuffer:
                    time.sleep(0.2)

            if (
                len(data_array)
                > self.mininum_required_speaking_seconds * source.sampling_rate
            ):
                yield self.recognize(data_array)

            is_last = False
            data_array = []

    # ------------------------------------------------------------------
    # Real-time chunked streaming
    # ------------------------------------------------------------------

    def enable_real_time_streaming(
        self, streaming_model, secondary_model=None, string_parts=True,
        pipeline_depth: int = 0,
    ):
        """Set up real-time (unidirectional) streaming recognition.
        ``pipeline_depth`` > 0 delivers each chunk's partial that many
        chunks later (engine.enable_streaming); finals are unchanged."""
        self.update_model(streaming_model)
        self.danspeech_recognizer.enable_streaming(
            secondary_model, string_parts, pipeline_depth=pipeline_depth
        )
        self.stream = True

    def disable_real_time_streaming(self, keep_secondary_model_loaded=False):
        if self.stream:
            print("Stopping stream...")
            self.stream = False
            if self.stream_thread_stopper is not None:  # a listener was started
                self.stream_thread_stopper(wait_for_stop=False)
            self.danspeech_recognizer.disable_streaming(
                keep_secondary_model=keep_secondary_model_loaded
            )
        else:
            print("No stream is running for the Recognizer")

    def real_time_streaming(self, source):
        """Generator yielding (is_last, partial_or_final_transcript).

        The model needs ``(context-1)*2`` new spectrogram frames per step,
        and 15 more 10 ms blocks on the first pass for the conv left
        padding: 8640 samples first and 6240 after it at context 20.
        """
        lookahead_context = self.danspeech_recognizer.model.context
        required_spec_frames = (lookahead_context - 1) * 2
        samples_pr_10ms = int(source.sampling_rate / 100)
        general_sample_requirement = samples_pr_10ms * 2 + (
            samples_pr_10ms * (required_spec_frames - 1)
        )
        first_sample_requirement = general_sample_requirement + (samples_pr_10ms * 15)

        data_array = []
        is_first_data = True
        is_first_pass = True
        stopper, data_getter = self.listen_in_background(source)
        self.stream_thread_stopper = stopper
        is_last = False
        output = None
        consecutive_fails = 0
        data_success = False
        time.sleep(0.2)  # let the listener thread spin up
        while self.stream:
            while True:
                if is_last:
                    break
                try:
                    if is_first_data:
                        is_last, data_array = data_getter()
                        is_first_data = False
                        data_success = True
                    else:
                        is_last, temp = data_getter()
                        data_array = np.concatenate((data_array, temp))
                        data_success = True
                except NoDataInBuffer:
                    if data_success:
                        data_success = False
                        consecutive_fails = 0
                        break
                    if is_first_data:
                        time.sleep(0.4)
                    else:
                        consecutive_fails += 1
                    if consecutive_fails == 2:
                        consecutive_fails = 0
                        time.sleep(0.3)

            if is_first_pass:
                if is_last:
                    output = None
                elif len(data_array) >= first_sample_requirement:
                    output = self.danspeech_recognizer.streaming_transcribe(
                        data_array, is_last=False, is_first=True
                    )
                    is_first_pass = False
                    data_array = []
                    is_first_data = True
            else:
                if is_last:
                    output = self.danspeech_recognizer.streaming_transcribe(
                        data_array, is_last=is_last, is_first=False
                    )
                    data_array = []
                    is_first_data = True
                elif len(data_array) >= general_sample_requirement:
                    output = self.danspeech_recognizer.streaming_transcribe(
                        data_array, is_last=is_last, is_first=False
                    )
                    data_array = []
                    is_first_data = True

            if is_last and output:
                yield is_last, output
            elif output:
                yield is_last, output
                output = None

            if is_last:
                is_first_pass = True
                is_last = False
                output = None

    # ------------------------------------------------------------------
    # Microphone calibration
    # ------------------------------------------------------------------

    def adjust_for_speech(self, source, duration=4):
        """Calibrate the energy threshold while the user talks: the mean
        RMS of ``duration`` seconds of buffers, less 80 where it exceeds 80."""
        assert isinstance(source, SpeechSource), "Source must be an audio source"
        assert source.stream is not None
        assert self.pause_threshold >= self.non_speaking_duration >= 0

        seconds_per_buffer = (source.chunk + 0.0) / source.sampling_rate
        elapsed_time = 0.0
        energy_levels = []
        while True:
            elapsed_time += seconds_per_buffer
            if elapsed_time > duration:
                break
            buffer = source.stream.read(source.chunk)
            energy_levels.append(rms(buffer, source.sampling_width))

        energy_average = sum(energy_levels) / len(energy_levels)
        if energy_average > 80:
            self.energy_threshold = energy_average - 80
        else:
            self.energy_threshold = energy_average

    def adjust_for_ambient_noise(self, source, duration=2):
        """Calibrate the energy threshold from background noise only: the
        dynamic threshold's damped update over ``duration`` seconds."""
        assert isinstance(source, SpeechSource), "Source must be an audio source"
        assert source.stream is not None
        assert self.pause_threshold >= self.non_speaking_duration >= 0

        seconds_per_buffer = (source.chunk + 0.0) / source.sampling_rate
        elapsed_time = 0.0
        while True:
            elapsed_time += seconds_per_buffer
            if elapsed_time > duration:
                break
            buffer = source.stream.read(source.chunk)
            energy = rms(buffer, source.sampling_width)
            damping = self.dynamic_energy_adjustment_damping ** seconds_per_buffer
            target_energy = energy * self.dynamic_energy_ratio
            self.energy_threshold = (
                self.energy_threshold * damping + target_energy * (1 - damping)
            )

    def update_stream_parameters(
        self,
        energy_threshold=None,
        pause_threshold=None,
        phrase_threshold=None,
        non_speaing_duration=None,
    ):
        """Tune the VAD parameters (the original's argument names, its
        misspelling included); ``None`` or 0 keeps a value."""
        if energy_threshold:
            self.energy_threshold = energy_threshold
        if pause_threshold:
            self.pause_threshold = pause_threshold
        if phrase_threshold:
            self.phrase_threshold = phrase_threshold
        if non_speaing_duration:
            self.non_speaking_duration = non_speaing_duration
