"""What the harness loads holds no module whose whole top-level name is
``jax``, ``jaxlib``, ``flax`` or ``danspeech_tpu``; the reference loads
nothing of ``danspeech_tpu_torch``."""

import glob
import json
import os
import subprocess
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def top_level_modules(code: str) -> set:
    probe = (code + "\nimport json, sys\n"
             "print(json.dumps(sorted({m.partition('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, check=True,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join([BENCH_DIR, ROOT])})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_readers_and_drivers_load_no_jax():
    readers = sorted(glob.glob(os.path.join(BENCH_DIR, "metrics", "*.py")))
    drivers = sorted(glob.glob(os.path.join(BENCH_DIR, "drivers", "*.py")))
    code = ("import harness, control, run, driver\n"
            "import danspeech_tpu_torch, danspeech_tpu_torch.engine\n"
            "import danspeech_tpu_torch.ops.gru_cuda\n"
            + "".join(f"harness.reader({os.path.basename(p)[:-3]!r})\n" for p in readers)
            + "".join(f"driver.load({os.path.basename(p)[:-3]!r})\n" for p in drivers))
    loaded = top_level_modules(code)
    assert "danspeech_tpu_torch" in loaded and "harness" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "danspeech_tpu"}


def test_reference_loads_nothing_of_the_program():
    loaded = top_level_modules("import reference.deepspeech_ref, check")
    assert not loaded & {"danspeech_tpu_torch", "danspeech_tpu", "jax", "jaxlib", "flax"}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    import types

    import harness

    monkeypatch.setitem(sys.modules, "danspeech_tpu_torch_probe", types.ModuleType("probe"))
    assert "danspeech_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "danspeech_tpu.probe", types.ModuleType("probe"))
    assert "danspeech_tpu" in harness.forbidden_modules()
