"""Run one cell of the port's benchmark once, and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. The run builds (or loads) the program's kernels, makes its weights and
inputs on the card from ``--seed``, warms up, measures for ``--seconds``,
checks what the timed path produced against the plain reference, and prints
one JSON object as the last line of standard output: the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1`` (over a
shorter traced window, with the device's busy seconds and a breakdown).
Each number compared is printed beside its limit as the last lines of
standard error, and under ``checks`` in the result.

Without a card (or with fewer than the cell asks for), or if a module of
JAX or of the JAX package is loaded once the window has closed, it exits
with a code other than 0 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import core  # noqa: E402
from portbench.trace import Tracer  # noqa: E402

EXIT_NO_CARD = 2
EXIT_FORBIDDEN = 3


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def read_metrics(entries, window, cell, view):
    """{name: {value, unit}} of each per-layer metric whose reader found
    something to read; the others are left out."""
    out = {}
    for m in entries:
        value = core.load_reader(m["name"]).read(view, window, cell)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None, *, need_card: bool = True, device=None, fault=None, overrides=None,
         t_start: float = T_START, record: Optional[dict] = None) -> int:
    """``need_card=False``, ``device``, ``fault``, ``overrides`` and
    ``record`` are for the benchmark's own tests and its readings
    (``readings.py``): a run on the CPU, with a planted fault or the control
    (``fault="control"``), whose readings and result go into ``record``."""
    args = parse(argv)
    cell = core.load_cell(args.workload, args.seed, args.seconds, bool(args.trace), overrides)
    core.set_environment(cell)
    import torch

    imported_s = time.perf_counter() - t_start

    if need_card:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            print(f"portbench: the cell needs {cell.chips} CUDA device(s); found {have}",
                  file=sys.stderr)
            return EXIT_NO_CARD
        device = torch.device("cuda", 0)
    man = core.manifest()
    e2e, per_layer = core.cell_metrics(man, cell.name)
    kind = core.load_kind(cell.kind).Kind(cell, device, fault=fault)
    kind.setup()
    setup_s = time.perf_counter() - t_start
    tracer = Tracer(bool(args.trace))
    window = kind.window(tracer)
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind.release()
    gc.collect()
    t_ref = time.perf_counter()
    readings = kind.readings()
    checks = core.checks_from(readings, cell.limits)
    reference_s = time.perf_counter() - t_ref
    found = core.forbidden_modules(list(sys.modules))
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return EXIT_FORBIDDEN
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": all(c.ok for c in checks), "attempted": window.attempted,
              "failed": window.failed}
    if args.trace:
        view = window.trace
        result["metrics"] = read_metrics(per_layer, window, cell, view)
        device_info.update(busy_s=view.busy_s, window_s=view.window_s)
        result["device"] = device_info
        result["breakdown"] = view.breakdown()
    else:
        values = {"setup_s": setup_s, **window.e2e}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in e2e}
        result["device"] = device_info
    print(f"import {imported_s:.2f} s; {kind.stages.line()}; reference {reference_s:.2f} s",
          file=sys.stderr)
    print(f"readings {json.dumps(readings)}", file=sys.stderr)
    core.emit(result, checks)
    if record is not None:
        record.update(readings=readings, result=result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
