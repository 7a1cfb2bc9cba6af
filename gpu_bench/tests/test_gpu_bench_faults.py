"""A whole run on the CPU at a tiny size (the chip's look skipped), sound
and with the timed path broken underneath: each fault a cell can have
makes ``correct`` false. (One chip: no exchange between chips to leave out.)"""

import numpy as np
import pytest
import torch

import harness

SEED = 2**31 + 17


def tiny(cell: str):
    _, config, mix = harness.cell_parts(harness.benchmark(), cell)
    config = dict(config, rnn_hidden_size=32, rnn_layers=2)
    mix = dict(mix, calls=min(mix["calls"], 3), rows_per_call=min(mix["rows_per_call"], 4),
               max_s=2.0, check_requests=6)
    return config, mix


def run(cell: str):
    config, mix = tiny(cell)
    return harness.run_cell(cell, SEED, 0.5, False, device="cpu", config=config, mix=mix)


def state_unchanged(monkeypatch):
    """Every GRU walk returns its state as it came in: zero outputs."""
    from danspeech_tpu_torch.ops import gru_cuda

    def bidi(x, lengths, w_ih_f, w_ih_b, w_hh_f, *rest, **kw):
        h = w_hh_f.shape[0]
        zeros = torch.zeros(x.shape[0], x.shape[1], h, dtype=x.dtype)
        state = torch.zeros(x.shape[1], h)
        return zeros, zeros, state, state

    def scan(gx, lengths, w_hh, b_ih, b_hh, h0, *rest, **kw):
        return torch.zeros(gx.shape[0], gx.shape[1], w_hh.shape[0], dtype=gx.dtype), h0

    monkeypatch.setattr(gru_cuda, "gru_bidi_fused", bidi)
    monkeypatch.setattr(gru_cuda, "gru_scan", scan)


def half_left_out(monkeypatch):
    """The second half of every dispatch group's rows is never computed: its
    paths stay blank."""
    from danspeech_tpu_torch.engine import DanSpeechRecognizer

    forward = DanSpeechRecognizer._forward_greedy

    def first_half(self, params, waveforms, lengths):
        ids, out_lens = forward(self, params, waveforms, lengths)
        ids = ids.clone()
        ids[max(1, ids.shape[0] // 2):] = 0
        return ids, out_lens

    monkeypatch.setattr(DanSpeechRecognizer, "_forward_greedy", first_half)


def token_altered(monkeypatch):
    """Each answer has one character changed where the host collapses it."""
    from danspeech_tpu_torch import engine

    collapse = engine.collapse_batch

    def altered(*args, **kw):
        out = []
        for s in collapse(*args, **kw):
            i = len(s) // 2
            c = "q" if s[i : i + 1] != "q" else "x"
            out.append(s[:i] + c + s[i + 1 :])
        return out

    monkeypatch.setattr(engine, "collapse_batch", altered)


@pytest.mark.parametrize("cell", ["primary-batch", "streaming-batch", "primary-recognize"])
def test_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "compared"
    assert result["compared"]["max_logit_gap"]["value"] == 0.0


# a recognize call carries one row: it has no half to leave out
FAULTS = [(cell, fault) for cell in ("primary-batch", "streaming-batch", "primary-recognize")
          for fault in (state_unchanged, half_left_out, token_altered)
          if not (cell == "primary-recognize" and fault is half_left_out)]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = run(cell)
    assert not result["correct"]
    gap = result["compared"]["max_logit_gap"]
    assert gap["value"] > gap["limit"] or not np.isfinite(gap["value"])
