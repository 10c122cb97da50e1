"""Readings that a cell's limits are set from.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 2]

For each seed one run of the cell as ``run.py`` makes it (a short window),
printing the numbers that the check compares for the program.  For each
control seed the same inputs also go through the reference computed in the
configuration's ``control`` precision (operands of every product rounded to
TF32 for a float32 configuration, to fp8 e4m3 for a bf16 one), put in the
program's place; for each fault seed through the reference with each of the
driver's faults (half of every batch left out, the mean over the rest; one
label altered; for eval the top-1 tally off by one).  A train step that
returns its state unchanged reads 1 on ``change_gap`` by construction and is
not run.  Beside a train cell's numbers, each leaf's gap over its own norm
and the leaf (``check.own_norm_gaps``).  One JSON line per seed and reading.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path(__file__).resolve().parent.parent))


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def readings(run, seed: int, control: bool, faults: bool) -> list[dict]:
    """The program's numbers of ``run`` and, as asked, the control's and the
    faults' on the same inputs, each with the driver's diagnostics."""
    from manifest import Manifest

    c = run.cell
    driver = Manifest.driver(c.traffic["driver"])
    out = [{"seed": seed, "reading": "program", **{k: v["value"] for k, v in run.checks.items()},
            **driver.diagnostics(c, run.program_out)}]
    cases = [("control", c.cfg["control"], {})] if control else []
    if faults:
        cases += [(name, None, fault) for name, fault in driver.faults(c).items()]
    for name, precision, fault in cases:
        got = driver.reference(c, c.reference_model(precision), **fault)
        out.append({"seed": seed, "reading": name, **driver.readings(c, got),
                    **driver.diagnostics(c, got)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from cell import run_cell

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = run_cell(args.workload, seed, args.seconds, False, t_start=t0,
                       device=args.device)
        for line in readings(run, seed, seed in args.control_seeds,
                             seed in args.fault_seeds):
            print(json.dumps({"workload": args.workload, "correct": run.correct, **line}),
                  flush=True)
        del run
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
