"""The readings that set a cell's limit on ``max_logit_gap``; not part of a
benchmark run.

    python3 gpu_bench/control.py --workload <cell> --seeds 11 12 ...

For each seed it builds the cell as a run does (weights, the program through
its package path, the traffic pool), serves the pool once through the
window's own call, samples the requests as a run does, and prints one JSON
line: the program's widest gap against the float32 reference (the lower
reading), and the control's: the reference itself with every bf16 product
taken in fp8 e4m3 put in the program's place, its greedy text held to the
same comparison (the upper reading), and its widest per-frame gap.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH_DIR))


def readings(name: str, seed: int) -> dict:
    import driver
    import harness

    _, config, mix = harness.cell_parts(harness.benchmark(), name)
    d = driver.load(mix["driver"])(config, mix, seed, "cuda")
    outputs = [d.call(entry) for entry in d.pool]
    records = [(0.0, 0.0, c, d.answered(entry, out))
               for c, (entry, out) in enumerate(zip(d.pool, outputs))]
    requests = d.sample(records)
    d.release()
    gaps = d.gaps(requests, outputs, control=True)
    return {"workload": name, "seed": seed, "program": max(gaps["text"]),
            "control": max(gaps["control_text"]), "control_frame": max(gaps["control_frame"]),
            "limit": config["limits"]["max_logit_gap"]}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
