"""The port's spans (``utils/profiling.annotate``) in the engine and the
model's forward pass, on the CPU with a tiny seeded model.

With no profiler a span is one shared no-op and ``record_function`` is
never called. Under ``torch.profiler`` a batch call exports one
``engine.call`` holding every other span of the call: the plan once, then
for each dispatch group the stage, upload, forward (with one ``model.rnn``
a layer inside), device-to-host copies and the collapse, or a beam
decoder's ``decode`` in its place. The CPU has no event to wait on, so no
``engine.wait``. Transcripts are the same with the profiler on.
"""

import contextlib
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from danspeech_tpu_torch.engine import DanSpeechRecognizer
from danspeech_tpu_torch.models import DeepSpeechModel
from danspeech_tpu_torch.models.config import DeepSpeechConfig
from danspeech_tpu_torch.utils import profiling
from test_torch_lm import arpa_text, write_text

LAYERS = 2
CFG = DeepSpeechConfig(rnn_hidden_size=32, rnn_layers=LAYERS, conv_layers=3)
PER_GROUP = ("engine.stage", "engine.upload", "engine.forward", "engine.d2h")


@pytest.fixture(scope="module")
def engine():
    eng = DanSpeechRecognizer(device="cpu")
    eng.update_model(DeepSpeechModel.init_random(CFG, seed=3))
    return eng


def waves(*lengths):
    rng = np.random.default_rng(0)
    return [np.clip(rng.normal(size=n) * 3000, -32768, 32767).astype(np.int16)
            for n in lengths]


# sixteen rows of half a second and one of three: cheaper as two groups (16
# padded rows a second and one row three seconds) than as 32 padded rows
# walked three seconds
TWO_GROUPS = (8000,) * 16 + (48000,)


def traced(tmp_path, fn):
    """(fn's result, [(name, start us, end us)] of the program's spans in
    the exported trace, in start order)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in events if e.get("cat") == "user_annotation"
                   and e.get("ph") == "X" and e["name"].startswith(("engine.", "model.")))
    return out, [(n, s, t) for s, t, n in spans]


def inside(span, outer) -> bool:
    return outer[1] <= span[1] and span[2] <= outer[2]


def check_call(spans, groups: int, last: str):
    """One engine.call holding the plan, ``groups`` of each group span and
    of ``last``, and one model.rnn a layer inside each engine.forward."""
    counts = Counter(n for n, _, _ in spans)
    assert counts["engine.call"] == 1 and counts["engine.plan"] == 1
    for name in PER_GROUP + (last,):
        assert counts[name] == groups, name
    assert counts["engine.wait"] == 0
    assert counts["model.rnn"] == LAYERS * groups
    assert counts["model.lookahead"] == 0  # a bidirectional model
    call = next(s for s in spans if s[0] == "engine.call")
    assert all(inside(s, call) for s in spans)
    for fwd in (s for s in spans if s[0] == "engine.forward"):
        held = Counter(s[0] for s in spans if s[0].startswith("model.") and inside(s, fwd))
        assert held == {"model.features": 1, "model.conv": 1, "model.rnn": LAYERS,
                        "model.head": 1}


def test_no_profiler_no_record_function(engine, monkeypatch):
    assert not torch.autograd._profiler_enabled()
    off = profiling.annotate("engine.call")
    assert isinstance(off, contextlib.nullcontext)
    assert off is profiling.annotate("model.rnn")
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or contextlib.nullcontext())
    texts = engine.transcribe_batch(waves(*TWO_GROUPS))
    assert len(texts) == len(TWO_GROUPS) and opened == []


def test_batch_call_spans(engine, tmp_path):
    recs = waves(*TWO_GROUPS)
    assert len(engine._plan_groups(recs)) == 2
    plain = engine.transcribe_batch(recs)
    texts, spans = traced(tmp_path, lambda: engine.transcribe_batch(recs))
    assert texts == plain
    check_call(spans, groups=2, last="engine.collapse")
    assert "engine.decode" not in {n for n, _, _ in spans}
    # the plan comes first, then each group in dispatch order
    order = [n for n, _, _ in spans if n in ("engine.plan",) + PER_GROUP]
    assert order == ["engine.plan"] + list(PER_GROUP) * 2


def test_recognize_spans(engine, tmp_path):
    rec = waves(24000)[0]
    plain = engine.transcribe(rec)
    text, spans = traced(tmp_path, lambda: engine.transcribe(rec))
    assert text == plain
    check_call(spans, groups=1, last="engine.collapse")


def test_host_beam_decode_span(tmp_path):
    eng = DanSpeechRecognizer(device="cpu")
    eng.update_model(DeepSpeechModel.init_random(CFG, seed=3))
    arpa = write_text(os.path.join(str(tmp_path), "lm.arpa"),
                      arpa_text(5, ["en", "to", "tre", "fire", "de", "et"]))
    eng.update_decoder(lm=arpa, backend="host", beam_width=8)
    recs = waves(*TWO_GROUPS)
    plain = eng.transcribe_batch(recs)
    texts, spans = traced(tmp_path, lambda: eng.transcribe_batch(recs))
    assert texts == plain
    check_call(spans, groups=2, last="engine.decode")
    assert "engine.collapse" not in {n for n, _, _ in spans}


def test_spans_leave_the_forward_pass_alone():
    """The model's spans sit in ``deepspeech.forward``: the same
    probabilities with and without a profiler."""
    from danspeech_tpu_torch.models import deepspeech as ds

    model = DeepSpeechModel.init_random(CFG, seed=4)
    x = torch.randn(2, 1, 161, 60)
    lengths = torch.tensor([60, 41])
    ref, ref_lens = ds.forward(model.params, model.config, x, lengths)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, out_lens = ds.forward(model.params, model.config, x, lengths)
    assert torch.equal(out, ref) and torch.equal(out_lens, ref_lens)
    names = Counter(e.name for e in prof.events() if e.name.startswith("model."))
    assert names == {"model.conv": 1, "model.rnn": LAYERS, "model.head": 1}
