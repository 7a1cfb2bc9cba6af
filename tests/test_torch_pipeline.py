"""The port's pipelined transcriber (danspeech_tpu_torch/parallel/pipeline.py)
in one process on the CPU, ``devices=["cpu"] * n``, against the port's
single-device engine and the JAX package. Twin of tests/test_pipeline.py."""

import numpy as np
import pytest
import torch

from torch_ranks import jax_state_dict, port_model

CFG = dict(model_name="pp-test", rnn_hidden_size=64, rnn_layers=4, conv_layers=2)
UNI_CFG = dict(model_name="pp-uni", rnn_hidden_size=64, rnn_layers=3, conv_layers=2,
               bidirectional=False, context=20)


@pytest.mark.parametrize("n_rnn", range(1, 10))
def test_partition_layers_equals_jax(n_rnn):
    """Every split of 1..9 layers into 1..n_rnn stages is the JAX package's;
    more stages than layers raises in both."""
    from danspeech_tpu.parallel.pipeline import partition_layers as jpartition
    from danspeech_tpu_torch.parallel import partition_layers

    for n_stages in range(1, n_rnn + 1):
        got = partition_layers(n_rnn, n_stages)
        assert got == jpartition(n_rnn, n_stages)
        assert [i for r in got for i in r] == list(range(n_rnn))
    with pytest.raises(ValueError):
        partition_layers(n_rnn, n_rnn + 1)
    if n_rnn == 9:
        assert [len(r) for r in partition_layers(9, 4)] == [2, 3, 2, 2]


@pytest.fixture(scope="module")
def model():
    return port_model(CFG, jax_state_dict(CFG, seed=17, bn_seed=18))


@pytest.fixture(scope="module")
def waves():
    rng = np.random.default_rng(5)
    return [(rng.normal(size=n) * 1500).astype(np.float32)
            for n in (9000, 15000, 12000, 16000, 8000, 14000, 11000)]


def _engine(model):
    from danspeech_tpu_torch.engine import DanSpeechRecognizer

    return DanSpeechRecognizer(model_name=model, device="cpu")


def _greedy(model):
    from danspeech_tpu_torch.decode.greedy import GreedyDecoder

    return GreedyDecoder(labels=model.labels, blank_index=model.labels.index("_"))


def test_pipeline_matches_single_device(model, waves):
    """Four stages on four CPU 'devices', microbatches of 3: the engine's
    transcripts, and the JAX package's pipeline."""
    from danspeech_tpu.parallel.pipeline import PipelinedTranscriber as JPipe
    from danspeech_tpu_torch.parallel import PipelinedTranscriber
    from torch_ranks import jax_model

    singles = _engine(model).transcribe_batch(waves)
    pp = PipelinedTranscriber(model, devices=["cpu"] * 4, n_stages=4, micro_batch=3)
    assert [len(r) for r in pp.stage_layers] == [1, 1, 1, 1]
    assert pp.transcribe(waves, _greedy(model)) == singles
    jpp = JPipe(jax_model(CFG, jax_state_dict(CFG, seed=17, bn_seed=18)),
                n_stages=4, micro_batch=3)
    assert jpp.transcribe(waves, _greedy(model)) == singles


def test_pipeline_stage_params_are_placed(model):
    """Each stage holds its slice of the parameters on its device: the conv
    stack only on stage 0, the head only on the last."""
    from danspeech_tpu_torch.models.deepspeech import map_params
    from danspeech_tpu_torch.parallel import PipelinedTranscriber

    pp = PipelinedTranscriber(model, devices=["cpu", "cpu"], micro_batch=4)
    assert pp.n_stages == 2
    for s, piece in enumerate(pp._stage_params):
        devices = set()
        map_params(lambda t: devices.add(t.device) or t, piece)
        assert devices == {pp.devices[s]}
        assert len(piece["rnns"]) == len(pp.stage_layers[s])
    assert "conv" in pp._stage_params[0] and "conv" not in pp._stage_params[-1]
    assert "fc" in pp._stage_params[-1] and "fc" not in pp._stage_params[0]
    with pytest.raises(ValueError, match="exceeds"):
        PipelinedTranscriber(model, devices=["cpu"], n_stages=2)


def test_pipeline_unidirectional_lookahead(waves):
    """Three stages of a unidirectional model: the last carries the
    lookahead."""
    from danspeech_tpu_torch.parallel import PipelinedTranscriber

    m = port_model(UNI_CFG, jax_state_dict(UNI_CFG, seed=21, bn_seed=22))
    singles = _engine(m).transcribe_batch(waves[:4])
    pp = PipelinedTranscriber(m, devices=["cpu"] * 3, micro_batch=2)
    assert "lookahead" in pp._stage_params[-1]
    assert pp.transcribe(waves[:4], _greedy(m)) == singles


def test_pipeline_remainder_microbatch_padded(model, waves):
    """The final microbatch pads to micro_batch rows and the pad rows are
    sliced off; the rows' probabilities do not depend on the split."""
    from danspeech_tpu_torch.models import deepspeech as ds
    from danspeech_tpu_torch.parallel import PipelinedTranscriber

    pp = PipelinedTranscriber(model, devices=["cpu"] * 2, micro_batch=4)
    probs, lens = pp.acoustic_probs(waves[:5])  # 4 + a 1-row remainder
    assert probs.shape[0] == 5 and lens.shape[0] == 5
    probs7, lens7 = pp.acoustic_probs(waves)  # 4 + 3
    np.testing.assert_allclose(probs7[:5], probs, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(lens7[:5], lens)
    # against the single-device forward of the same padded batch
    eng = _engine(model)
    batch = np.zeros((5, pp.SAMPLE_BUCKET), np.float32)  # one bucket holds them
    for j, w in enumerate(waves[:5]):
        batch[j, : len(w)] = w
    ref, ref_lens = eng._forward(ds.params_to(model.params, "cpu"), torch.from_numpy(batch),
                                 torch.tensor([len(w) for w in waves[:5]]))
    np.testing.assert_array_equal(ref_lens.numpy(), lens)
    np.testing.assert_allclose(probs, ref.numpy(), rtol=0, atol=1e-5)
    empty_p, empty_l = pp.acoustic_probs([])
    assert empty_p.shape[0] == 0 and empty_l.shape[0] == 0
