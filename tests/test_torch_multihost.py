"""Two OS processes joined by the port's ``initialize_multihost`` (a TCP
rendezvous on a free local port, gloo on the CPU) run the data-parallel
transcriber: each greedy-decodes the rows its rank holds, and the union of
their transcripts equals the single-process engine's. Twin of
tests/test_multihost.py.

Run as a script, this file is one of the two processes:
``python test_torch_multihost.py <process_id> <port> <workdir>``.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
CFG = dict(model_name="mh-test", rnn_hidden_size=48, rnn_layers=2, conv_layers=2)


def _waves():
    rng = np.random.default_rng(21)
    return [(rng.normal(size=n) * 2000).astype(np.float32)
            for n in (9600, 14000, 16000, 12000, 8000, 15000)]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child(process_id: int, port: int, workdir: str) -> None:
    import torch

    from danspeech_tpu_torch.decode.greedy import collapse_batch
    from danspeech_tpu_torch.parallel import ShardedTranscriber, initialize_multihost, make_mesh
    from torch_ranks import port_model

    torch.set_num_threads(1)
    initialize_multihost(f"127.0.0.1:{port}", num_processes=2, process_id=process_id,
                         device="cpu")
    mesh = make_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.size("data")) == (2, process_id, 2)
    with open(os.path.join(workdir, "weights.pkl"), "rb") as f:
        sd = pickle.load(f)
    model = port_model(CFG, sd)
    waves = _waves()
    tr = ShardedTranscriber(model, mesh, shard_model_params=False)
    lo, probs, out_lens = tr.local_acoustic_probs(waves)
    labels = model.labels
    strings = collapse_batch(probs.argmax(-1).numpy(), out_lens.numpy(), labels,
                             labels.index("_"))
    with open(os.path.join(workdir, f"proc{process_id}.tsv"), "w") as f:
        for j, s in enumerate(strings):
            if lo + j < len(waves):
                f.write(f"{lo + j}\t{s}\n")
    torch.distributed.destroy_process_group()


def test_two_process_dp_matches_single_process(tmp_path):
    from danspeech_tpu_torch.engine import DanSpeechRecognizer
    from torch_ranks import jax_state_dict, port_model

    sd = jax_state_dict(CFG, seed=11, bn_seed=12)
    with open(tmp_path / "weights.pkl", "wb") as f:
        pickle.dump(sd, f)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, HERE] + [
        p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), str(pid), str(port),
                          str(tmp_path)], env=env, cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)
    ]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, f"child failed:\n{out[-3000:]}"

    rows = {}
    for pid in (0, 1):
        with open(tmp_path / f"proc{pid}.tsv") as f:
            for line in f:
                i, _, s = line.rstrip("\n").partition("\t")
                rows[int(i)] = s
    waves = _waves()
    assert sorted(rows) == list(range(len(waves)))
    eng = DanSpeechRecognizer(model_name=port_model(CFG, sd), device="cpu")
    assert [rows[i] for i in range(len(waves))] == eng.transcribe_batch(waves)


if __name__ == "__main__":
    sys.path[:0] = [REPO, HERE]
    _child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
