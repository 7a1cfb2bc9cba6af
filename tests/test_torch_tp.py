"""The port's tensor parallelism (danspeech_tpu_torch/parallel/tp.py) on
spawned gloo ranks on the CPU, against the JAX package's ``tp_forward`` on
its CPU mesh and the port's ``forward``. Twin of tests/test_tp.py.

Each world size runs every case in one spawned group. Top-level imports
stay torch, numpy and the port.
"""

import numpy as np
import pytest
import torch

from torch_ranks import jax_model, jax_state_dict, port_model, run_ranks

BIDI = dict(rnn_hidden_size=64, rnn_layers=2, conv_layers=2, bidirectional=True)
UNI = dict(rnn_hidden_size=64, rnn_layers=2, conv_layers=2, bidirectional=False,
           context=20)
# (name, config, mode, model-axis size)
CASES = [
    ("direction", BIDI, "direction", 2),
    ("hidden_bidi_2", BIDI, "hidden", 2),
    ("hidden_bidi_4", BIDI, "hidden", 4),
    ("hidden_uni_4", UNI, "hidden", 4),
    ("auto_bidi_2", BIDI, "auto", 2),
    ("auto_uni_2", UNI, "auto", 2),
]


def _inputs(tmax=40):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 1, 161, tmax)).astype(np.float32)
    lengths = [tmax, tmax - 13]
    x[1, :, :, lengths[1]:] = 0.0
    return x, lengths


def _tp_rank(rank, n, sds):
    from danspeech_tpu_torch.ops import gru_cuda
    from danspeech_tpu_torch.parallel import make_mesh, pack_tp_params, tp_forward
    from danspeech_tpu_torch.parallel import mesh as pm
    from danspeech_tpu_torch.parallel.tp import resolve_mode

    mesh = make_mesh(n_data=1, n_model=n, device="cpu")
    x, lengths = _inputs()
    scans = {"n": 0}
    inner = gru_cuda.gru_scan

    def counted(*a, **k):
        scans["n"] += 1
        return inner(*a, **k)

    gru_cuda.gru_scan = counted
    out = {}
    for name, kw, mode, size in CASES:
        if size != n:
            continue
        model = port_model(dict(kw, model_name=name), sds[name])
        resolved = resolve_mode(model.config, n, mode)
        params = model.params if resolved == "direction" else pack_tp_params(model.params, n)
        scans["n"] = 0
        gathers = pm.all_gather.calls
        probs, lens = tp_forward(params, model.config, torch.from_numpy(x),
                                 torch.tensor(lengths), mesh, mode=mode)
        out[name] = (probs.numpy(), lens.numpy(), resolved, scans["n"],
                     pm.all_gather.calls - gathers)
    try:
        model = port_model(dict(UNI, model_name="bad"), sds["hidden_uni_4"])
        tp_forward(model.params, model.config, torch.from_numpy(x), torch.tensor(lengths),
                   mesh, mode="direction")
    except ValueError as e:
        out["direction_uni_error"] = str(e)
    return out


@pytest.fixture(scope="module")
def sds():
    return {name: jax_state_dict(dict(kw, model_name=name), seed=i, bn_seed=i + 1)
            for i, (name, kw, _, _) in enumerate(CASES)}


@pytest.fixture(scope="module")
def ranks(sds, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    return {n: run_ranks(_tp_rank, n, tmp, sds) for n in (2, 4)}


def _jax_tp(name, kw, mode, n, sd):
    import jax.numpy as jnp

    from danspeech_tpu.parallel.mesh import make_mesh
    from danspeech_tpu.parallel.tp import pack_tp_params, tp_forward

    model = jax_model(dict(kw, model_name=name), sd)
    x, lengths = _inputs()
    mesh = make_mesh(n_data=8 // n, n_model=n)
    resolved = mode
    if mode == "auto":
        resolved = "direction" if (model.config.bidirectional and n == 2) else "hidden"
    params = model.params if resolved == "direction" else pack_tp_params(model.params, n)
    probs, lens = tp_forward(params, model.config, jnp.asarray(x),
                             jnp.asarray(lengths), mesh, axis="model", mode=mode)
    return np.asarray(probs), np.asarray(lens)


@pytest.mark.parametrize("name,kw,mode,n", CASES, ids=[c[0] for c in CASES])
def test_tp_forward_matches_jax_and_forward(ranks, sds, name, kw, mode, n):
    """Every rank's probabilities equal the port's replicated forward and
    the JAX package's tp_forward (atol 2e-5). Direction mode runs one
    gru_scan a layer on each rank; hidden mode runs no kernel and one
    all_gather a step a layer, plus the layer outputs'."""
    from danspeech_tpu_torch.models import deepspeech as ds

    model = port_model(dict(kw, model_name=name), sds[name])
    x, lengths = _inputs()
    ref, ref_lens = ds.forward(model.params, model.config, torch.from_numpy(x),
                               torch.tensor(lengths))
    ref, ref_lens = ref.numpy(), ref_lens.numpy()
    jax_probs, _ = _jax_tp(name, kw, mode, n, sds[name])
    t_out = ref.shape[1]
    for out in ranks[n]:
        probs, lens, resolved, scans, gathers = out[name]
        np.testing.assert_array_equal(lens, ref_lens)
        for i, k in enumerate(ref_lens):
            np.testing.assert_allclose(probs[i, :k], ref[i, :k], atol=2e-5, rtol=1e-4)
            np.testing.assert_allclose(probs[i, :k], jax_probs[i, :k], atol=2e-5,
                                       rtol=1e-4)
        layers = kw["rnn_layers"]
        if resolved == "direction":
            assert (scans, gathers) == (layers, 0)
        else:
            lookahead = 0 if kw["bidirectional"] else 1
            assert (scans, gathers) == (0, layers * (t_out + 1) + lookahead)


def test_auto_picks_direction_only_for_a_2way_bidirectional_axis(ranks):
    assert ranks[2][0]["auto_bidi_2"][2] == "direction"
    assert ranks[2][0]["auto_uni_2"][2] == "hidden"
    assert ranks[4][0]["hidden_bidi_4"][2] == "hidden"
    for n in (2, 4):
        assert "direction mode needs" in ranks[n][0]["direction_uni_error"]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_pack_tp_params_equals_jax(n):
    """pack_tp_params on the same numpy weights permutes the gate columns
    exactly as the JAX package's."""
    from danspeech_tpu.models.config import DeepSpeechConfig as JConfig
    from danspeech_tpu.models import deepspeech as jds
    from danspeech_tpu.parallel.tp import pack_tp_params as jpack
    from danspeech_tpu_torch.parallel import pack_tp_params

    kw = dict(model_name="pack", **UNI)
    sd = jax_state_dict(kw, seed=9)
    got = pack_tp_params(port_model(kw, sd).params, n)
    ref = jpack(jds.init_params(JConfig(**kw), seed=9), n)
    for g, r in zip(got["rnns"], ref["rnns"]):
        for a, b in zip(g["fwd"], r["fwd"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="not divisible"):
        pack_tp_params(port_model(kw, sd).params, 3)
