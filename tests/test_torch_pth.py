"""The zoo's ``.pth`` packages in the PyTorch port against the JAX package
(CPU).

Packages are written here with ``torch.save`` in the original module's key
layout (``tests/test_checkpoint.py``'s ``make_package``: the two lookahead
layouts, BatchNorm's ``num_batches_tracked``), in the zip and the legacy
format. The JAX package reads them with its own torch-free unpickler, the
port with ``torch.load(weights_only=True)``: the parameters must be equal
and the float32 forward within F32_ATOL of the JAX one (softmax
probabilities, as ``test_torch_model.py``).
"""

import io
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from danspeech_tpu.models import DeepSpeechModel as JModel
from danspeech_tpu.models import checkpoint as jckpt
from danspeech_tpu.models import deepspeech as jds
from danspeech_tpu.models.config import DeepSpeechConfig as JConfig
from danspeech_tpu_torch.models import DeepSpeech, DeepSpeechModel as TModel
from danspeech_tpu_torch.models import checkpoint as tckpt
from danspeech_tpu_torch.models import deepspeech as tds
from danspeech_tpu_torch.models.torch_pickle import torch_load

from test_checkpoint import make_package

F32_ATOL = 1e-5

CASES = {
    "gru-bidi": dict(rnn_type="gru", conv_layers=2, rnn_hidden_size=32, rnn_layers=2),
    "gru-uni": dict(rnn_type="gru", bidirectional=False, conv_layers=2,
                    rnn_hidden_size=32, rnn_layers=2),
    "gru-streaming": dict(rnn_type="gru", streaming_model=True, conv_layers=2,
                          rnn_hidden_size=32, rnn_layers=2, context=20),
    "gru-3conv": dict(rnn_type="gru", conv_layers=3, rnn_hidden_size=24, rnn_layers=3),
    "lstm": dict(rnn_type="lstm", conv_layers=2, rnn_hidden_size=24, rnn_layers=2),
    "tanh": dict(rnn_type="rnn", conv_layers=2, rnn_hidden_size=24, rnn_layers=2),
}


def _spect(seed, n=3, t=90):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 1, 161, t)).astype(np.float32)
    lengths = np.array([t, t - 31, 17][:n], np.int32)
    x *= (np.arange(t)[None, :] < lengths[:, None])[:, None, None, :]
    return x, lengths


def _write(tmp_path, kw, zipfmt, seed=0):
    config = JConfig(model_name="pth-test", **kw)
    package = make_package(config, seed=seed)
    path = tmp_path / ("zip.pth" if zipfmt else "legacy.pth")
    torch.save(package, str(path), _use_new_zipfile_serialization=zipfmt)
    return str(path), package


@pytest.mark.parametrize("zipfmt", [True, False], ids=["zip", "legacy"])
@pytest.mark.parametrize("case", list(CASES))
def test_package_loads_as_in_jax_and_forwards_alike(tmp_path, case, zipfmt):
    path, package = _write(tmp_path, CASES[case], zipfmt)
    jcfg, jparams = jckpt.load_reference_checkpoint(path)
    tcfg, tparams = tckpt.load_reference_checkpoint(path)
    assert tcfg.to_dict() == jcfg.to_dict()
    assert "rnns.1.batch_norm.module.num_batches_tracked" in package["state_dict"]

    ref = jckpt.state_dict_from_params(jparams, jcfg)
    got = tckpt.state_dict_from_params(tparams, tcfg)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    # and the parameters are the package's tensors
    sd = package["state_dict"]
    np.testing.assert_array_equal(got["rnns.0.rnn.weight_hh_l0"],
                                  sd["rnns.0.rnn.weight_hh_l0"].numpy())

    x, lengths = _spect(1)
    want, want_len = jds.forward(jparams, jcfg, jnp.asarray(x), jnp.asarray(lengths))
    have, have_len = tds.forward(tparams, tcfg, torch.from_numpy(x),
                                 torch.from_numpy(lengths))
    np.testing.assert_array_equal(have_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(have.numpy(), np.asarray(want), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("zipfmt", [True, False], ids=["zip", "legacy"])
def test_load_model_and_load_model_package(tmp_path, zipfmt):
    path, package = _write(tmp_path, CASES["gru-uni"], zipfmt, seed=3)
    model = TModel.load_model(path)
    assert isinstance(model, DeepSpeech)  # the original class name
    jmodel = JModel.load_model(path)
    assert model.config.to_dict() == jmodel.config.to_dict()
    assert model.get_param_size() == jmodel.get_param_size()
    again = TModel.load_model_package(torch_load(path))
    ref = tckpt.state_dict_from_params(model.params, model.config)
    for k, v in tckpt.state_dict_from_params(again.params, again.config).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    assert model.context == 20 and model.labels == jmodel.labels


def test_labels_as_a_list_and_bf16_tensors(tmp_path):
    """Hyperparameters hold plain Python objects (labels as a list, the
    audio config as a dict); a bf16 state_dict loads as float32."""
    _, package = _write(tmp_path, CASES["gru-bidi"], True, seed=4)
    package["labels"] = list(package["labels"])
    package["state_dict"] = {k: (v.bfloat16() if v.is_floating_point() else v)
                             for k, v in package["state_dict"].items()}
    path = str(tmp_path / "bf16.pth")
    torch.save(package, path)
    config, params = tckpt.load_reference_checkpoint(path)
    jconfig, jparams = jckpt.load_reference_checkpoint(path)
    assert config.labels == jconfig.labels == "".join(package["labels"])
    assert config.audio_conf == jconfig.audio_conf
    got = tckpt.state_dict_from_params(params, config)
    for k, v in jckpt.state_dict_from_params(jparams, jconfig).items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_bytes_load_like_a_path(tmp_path):
    path, _ = _write(tmp_path, CASES["tanh"], True)
    with open(path, "rb") as f:
        raw = f.read()
    a, b = torch_load(path), torch_load(raw)
    assert sorted(a) == sorted(b)
    for k in a["state_dict"]:
        assert torch.equal(a["state_dict"][k], b["state_dict"][k])


class _Evil:
    def __reduce__(self):
        return (print, ("pwned",))


@pytest.mark.parametrize("zipfmt", [True, False], ids=["zip", "legacy"])
def test_a_foreign_global_is_refused(tmp_path, zipfmt):
    path = str(tmp_path / "evil.pth")
    torch.save({"state_dict": {}, "evil": _Evil()}, path,
               _use_new_zipfile_serialization=zipfmt)
    with pytest.raises(pickle.UnpicklingError):
        torch_load(path)
    with pytest.raises(pickle.UnpicklingError):
        TModel.load_model(path)


def test_a_legacy_header_pickle_is_refused(tmp_path):
    """The first pickle of a legacy stream carries the payload."""
    buf = io.BytesIO()
    pickle.dump(_Evil(), buf)
    path = tmp_path / "evil_legacy.pth"
    path.write_bytes(buf.getvalue())
    with pytest.raises(pickle.UnpicklingError):
        torch_load(str(path))
