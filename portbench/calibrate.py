"""Readings that the limits of ``correct`` are set from.

    python3 portbench/calibrate.py --workload <cell> --seconds 2 --seeds <n> [<n> ...] [--raw <dir>]

For each seed, in one process: a run of the cell at its own sizes with a
short window, its answers judged against the reference, and each control
(the reference with its forward rounded lower) judged
the same way on the same sample. Prints one JSON line a seed, then for each
number the program's largest reading over the seeds (the lower reading)
and each control's smallest (the upper one). With ``--raw``, each seed's
per-image readings (the program's, the reference's, the controls' and a
fault's scores) are saved there with ``torch.save``, for a look at other
statistics.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.reference.precision import CONTROLS  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--controls", nargs="+", default=sorted(CONTROLS))
    parser.add_argument("--raw", default=None)
    args = parser.parse_args()
    device = torch.device("cuda", 0)
    program, controls = [], {name: [] for name in args.controls}
    for seed in args.seeds:
        spec = harness.Spec(args.workload)
        out = harness.execute(spec, seed, args.seconds, False, device, time.perf_counter(), controls=args.controls,
                              record=bool(args.raw))
        program.append(out["numbers"])
        for name in args.controls:
            controls[name].append(out["control_numbers"][name])
        print(json.dumps({"seed": seed, "program": out["numbers"], "controls": out["control_numbers"],
                          "attempted": out["attempted"], "failed": out["failed"]}), flush=True)
        if args.raw:
            os.makedirs(args.raw, exist_ok=True)
            torch.save(out["raw"], os.path.join(args.raw, f"{args.workload}.{seed}.pt"))
    summary = {name: {"lower": max(p[name] for p in program),
                      **{control: min(c[name] for c in controls[control]) for control in args.controls}}
               for name in program[0]}
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds), "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
