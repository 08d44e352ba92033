"""The numbers a cell's check compares, over many seeds in one process: the
readings its limits are set from.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 [--fault F] [--seconds S]

Each seed is one whole run of ``run.py`` (``--trace 0``) in this process, so
that the set-up's imports are paid once. ``--fault`` plants one of the
traffic kind's faults, or puts the control in the program's place
(``control``: the reference, its products in float8). A train cell's
readings come from its first three steps, so a short ``--seconds`` will
do; an embed cell compares what its window served. After each run's own
result line, one JSON line with all its readings.
"""
import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        record = {}
        rc = run.main(["--workload", args.workload, "--seed", str(seed),
                       "--seconds", str(args.seconds), "--trace", "0"],
                      fault=args.fault, record=record, t_start=time.perf_counter())
        if rc:
            return rc
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "correct": record["result"]["correct"],
                          "readings": record["readings"]}), flush=True)
        del record
        gc.collect()
        import torch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
