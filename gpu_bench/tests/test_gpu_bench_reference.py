"""The plain reference against the port at a tiny width on the CPU, the
comparison that decides ``correct``, and the control: the reference in fp8
in the program's place comes out not correct."""

import math

import numpy as np
import pytest
import torch

import check
import harness
import mixes
import weights
from reference.deepspeech_ref import Model as Reference

SEED = 2**31 + 3


def tiny(cell: str, **kw):
    _, config, mix = harness.cell_parts(harness.benchmark(), cell)
    config = dict(config, **{"rnn_hidden_size": 32, "rnn_layers": 2, **kw})
    return config, dict(mix, calls=2, rows_per_call=3, max_s=2.0)


def made(config: dict) -> dict:
    """The weights as a run makes them: drawn, then calibrated."""
    sd = weights.state_dict(config, SEED, "cpu")
    weights.calibrate(sd, config, SEED, "cpu")
    return sd


@pytest.mark.parametrize("cell", ["primary-batch", "streaming-batch"])
def test_reference_matches_the_port(cell):
    from danspeech_tpu_torch import Recognizer
    from danspeech_tpu_torch.models import DeepSpeechModel

    config, mix = tiny(cell)
    sd = made(config)
    model = DeepSpeechModel.load_model_package(weights.package(config, sd))
    rec = Recognizer(model=model, device="cpu")
    waves = mixes.pool(mix, SEED, "cpu")[0]
    eng = rec.danspeech_recognizer
    idxs, maxlen = eng._plan_groups(waves)[0]
    staged, lengths = eng._stage_group(waves, idxs, maxlen)
    probs, out_lens = eng._forward(eng._compute_params, staged, torch.from_numpy(lengths))
    ref = Reference(sd, config).logits([waves[i] for i in idxs])
    for j, logits in enumerate(ref):
        n = int(out_lens[j])
        assert logits.shape == (n, len(config["labels"]))
        got = probs[j, :n].double()
        want = torch.softmax(logits.double(), dim=-1)
        # float32 on both sides, summed in other orders; the sharpened head's
        # logits reach about 100, so their rounding moves probabilities by
        # about 1e-4 near a tie
        assert float((got - want).abs().max()) < 1e-3
    texts = rec.recognize_batch(waves)
    for i, logits in zip(idxs, ref):
        assert check.text_gap(logits.numpy(), texts[i], config["labels"]) == 0.0


def test_text_gap_reads_the_served_path():
    labels = "_ab "
    logits = np.array([[0.0, 5.0, 1.0, 0.0],   # a
                       [0.0, 5.0, 1.0, 0.0],   # a (repeat)
                       [3.0, 0.0, 2.0, 0.0],   # blank, b 1 below
                       [0.0, 1.0, 4.0, 0.0]])  # b
    assert check.greedy_text(logits, labels) == "ab"
    assert check.text_gap(logits, "ab", labels) == 0.0
    # "aab" needs a blank between the two a's: a _ a b, the blank at frame 1
    assert check.text_gap(logits, "aab", labels) == 5.0
    # a b _ b: b at frame 1 lies 4 below a
    assert check.text_gap(logits, "abb", labels) == 4.0
    assert check.text_gap(logits, "", labels) == 5.0
    assert math.isinf(check.text_gap(logits, "ababa", labels))
    assert math.isinf(check.text_gap(logits, "ax", labels))
    assert check.frame_gap(logits, np.array([1, 1, 2, 2])) == 1.0


@pytest.mark.parametrize("cell", ["primary-batch", "streaming-batch"])
def test_control_comes_out_not_correct(cell):
    """The reference with every bf16 product taken in fp8, in the program's
    place, fails the cell's limit at a size a test run holds."""
    config, _ = tiny(cell, rnn_hidden_size=256)
    mix = dict(harness.cell_parts(harness.benchmark(), cell)[2], calls=1, rows_per_call=4,
               min_s=3.0, max_s=6.0)
    sd = made(config)
    waves = mixes.pool(mix, SEED, "cpu")[0]
    exact = Reference(sd, config).logits(waves)
    low = Reference(sd, config, control=True).logits(waves)
    labels = config["labels"]
    gaps = [check.text_gap(e.numpy(), check.greedy_text(c.numpy(), labels), labels)
            for e, c in zip(exact, low)]
    assert max(gaps) > config["limits"]["max_logit_gap"]
