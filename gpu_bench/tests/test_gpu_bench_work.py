"""Operations and bytes counted from the audio against hand counts."""

import pytest

import work

SMALL = {"rnn_hidden_size": 8, "rnn_layers": 2, "conv_layers": 2, "bidirectional": True,
         "context": 4, "labels": "_ab", "compute_dtype": "auto",
         "audio_conf": {"sampling_rate": 16000, "window_size": 0.02, "window_stride": 0.01}}


def test_frames_after_the_conv_stack():
    # 1 + n // 160 spectrogram frames, then (T + 10 - 11) // 2 + 1 and
    # (T + 10 - 11) // 1 + 1
    assert work.utterance_frames(16000, SMALL) == 51
    assert work.utterance_frames(15999, SMALL) == 50
    assert work.utterance_frames(128000, SMALL) == 401


def test_conv_counts_by_hand():
    # conv1: 161 -> 81 frequencies, 32 outputs of 41 x 11 taps of 1 input;
    # conv2: 81 -> 41, 32 -> 32 channels, 21 x 11 taps
    assert work.conv_ops(SMALL) == [2 * 41 * 11 * 1 * 32 * 81, 2 * 21 * 11 * 32 * 32 * 41]


def test_rnn_group_counts_by_hand():
    d, h, frames = 32 * 41, 8, 10
    assert work.rnn_layers(SMALL) == [(d, h, 2), (h, h, 2)]
    flops, nbytes = work.group_work(["rnn_projection", "rnn_recurrence"], SMALL, frames)
    assert flops == 2 * 2 * (d + h) * 3 * h * frames + 2 * 2 * (h + h) * 3 * h * frames
    per_call = (2 * ((d + h) * 3 * h * 2 + 2 * 3 * h * 4)
                + 2 * ((h + h) * 3 * h * 2 + 2 * 3 * h * 4))
    assert nbytes == frames * (d * 2 + 2 * h * 2) + frames * (h * 2 + 2 * h * 2) + per_call
    flops, nbytes = work.group_work(["rnn_recurrence"], SMALL, frames)
    assert flops == 2 * (2 * 2 * h * 3 * h * frames)
    assert nbytes == 2 * (frames * (2 * 3 * h * 2 + 2 * h * 2)
                          + 2 * (h * 3 * h * 2 + 2 * 3 * h * 4))


def test_published_widths_by_hand():
    primary = dict(SMALL, rnn_hidden_size=1200, rnn_layers=9, conv_layers=3, context=20,
                   labels="_" * 33)
    streaming = dict(primary, rnn_hidden_size=2000, rnn_layers=5, conv_layers=2,
                     bidirectional=False)
    # GFLOP an audio second at 50 frames a second: GRU 16.1 + convs 2.6
    assert work.model_flops_per_frame(primary) * 50 / 1e9 == pytest.approx(18.72, abs=0.01)
    assert work.model_flops_per_frame(streaming) * 50 / 1e9 == pytest.approx(12.68, abs=0.01)


def test_bound_takes_the_larger_side():
    assert work.bound_s(989e12, 0.0, SMALL) == pytest.approx(1.0)
    assert work.bound_s(0.0, 3.35e12, SMALL) == pytest.approx(1.0)
    assert work.bound_s(67e12, 0.0, dict(SMALL, compute_dtype="float32")) == pytest.approx(1.0)
