"""Readings of the correctness check on many seeds, for the program and
for its lower-precision control, in one process (not part of a run).

    python3 slam_bench/control.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault pose_unchanged --fault-seeds 7,8,9] \
        [--out FILE]

Each seed runs one complete session of the cell at its own size, through
the same harness as a run (``harness.run_cell`` with one session), and
prints one JSON line: the mode (``program``: float32 as the configuration
states; ``control``: the same with TF32 on for every float32 matmul and
convolution, the nearest precision below; ``fault:<name>``: the program with
a fault of ``faults.py`` planted), the seed and every reading the check can
compare. The limits in ``limits/<cell>.json`` are set from these readings:
above the largest of the program's, below the smallest of the control's or
a fault's. Needs a CUDA card.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    from slam_bench import faults, harness, run

    run.pin_caches()
    plan = ([("program", int(s)) for s in args.seeds.split(",") if s]
            + [("control", int(s)) for s in args.control_seeds.split(",")
               if s]
            + [("fault:" + str(args.fault), int(s))
               for s in args.fault_seeds.split(",") if s])
    rows = []
    for mode, seed in plan:
        planted = ([faults.FAULTS[args.fault]()]
                   if mode.startswith("fault:") else [])
        res = harness.run_cell(ROOT, args.workload, seed, 600.0, False,
                               device="cuda", tf32=(mode == "control"),
                               max_sessions=1, faults=planted)
        row = {"mode": mode, "seed": seed, "correct": res["correct"],
               "frames_per_s": res["readings"]["frames"]
               / res["readings"]["window_s"],
               "failed": res["failed"], **res["readings"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
