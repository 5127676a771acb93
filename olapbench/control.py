"""The control of ``correct``: the reference put in the program's place and
computed in float32, the precision below the configurations' float64.

    python3 olapbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the cell's tables as a run does, works out every
query of the cell's mix (of every stream, where it has several) in
float64 (the reference) and in float32 (the control), and compares the control's results with the reference's as a
run compares the program's, printing one JSON line a seed with the
numbers compared beside their limits. The control has to come out as not
correct; the smallest ``result_rel_err`` it reads is the upper reading
the limit sits below.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(tables, mix, device="cpu"):
    """(the widest relative gap of the control, queries that differ beyond
    rounding, the reasons)."""
    import torch
    from olapbench import compare, harness
    worst, wrong, why = 0.0, 0, []
    qids = harness.queries_of(mix)
    want = harness.references(tables, qids, device)
    got = harness.references(tables, qids, device, torch.float32)
    for qid in qids:
        fault, gap = compare.compare_result(got[qid], want[qid])
        worst = max(worst, gap)
        if fault is not None:
            wrong += 1
            why.append(f"{qid}: {fault}")
    return worst, wrong, why


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args()
    sys.path.insert(0, str(ROOT))
    from olapbench import compare, harness
    import torch
    _, config, mix, _ = harness.cell_parts(a.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in a.seeds:
        tables = harness.make_tables(config, seed, device)
        worst, wrong, why = readings(tables, mix, device)
        print(json.dumps({
            "workload": a.workload, "seed": seed, "device": device,
            "control_correct": (worst <= compare.LIMITS["result_rel_err"]
                                and wrong == 0),
            "result_rel_err": {"value": worst,
                               "limit": compare.LIMITS["result_rel_err"]},
            "result_mismatches": {"value": wrong, "limit": 0},
            "why": why}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
