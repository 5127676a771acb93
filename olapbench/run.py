"""Run one cell of the benchmark once and print its result line.

    python3 olapbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the card the cell asks
for. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``, then ``compared``); standard error ends with each
number compared beside its limit. Without a card, without the program
beside it, or with JAX or the JAX package loaded, it exits non-zero and
prints no result.
"""
import os
import time

T_START = time.perf_counter()
# one process with one host thread: the load stays that of the one client,
# and no idle thread pool spins on the cores that the client runs on
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the program (src/repro_torch) is not beside the benchmark",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    torch.set_num_threads(1)
    from olapbench import harness
    cell, _, _, _ = harness.cell_parts(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 3
    line = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                            T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules it must not load: {bad}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
