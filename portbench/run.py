"""The port's benchmark: one run of one cell on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``BENCHMARK.json`` names the cells; a cell's
configuration is ``portbench/configs/<config>.json``, its traffic
``portbench/traffic/<traffic>.json``, the driver the traffic names
``portbench/drivers/<driver>.py``, the wire the configuration names
``portbench/wires/<transfer>.<format>.py``, each per-layer metric's reader
``portbench/metrics/<metric>.py`` (``cell.py`` says what a run does).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones), ``device``
(``platform``, ``kind``, ``count``, ``memory_peak_bytes``; traced:
``busy_s``, ``window_s``), traced ``breakdown`` (``device_ops``,
``idle_gaps``), and last ``checks``: each number compared beside its limit,
which the last lines of standard error repeat.

A run exits non-zero and prints no result where no CUDA card is visible or
fewer than the cell's chips, where a file names a key that no part of the
harness reads, where a traced run's listed per-layer metric reads nothing,
and where ``jax``, ``jaxlib``, ``flax``, ``optax`` or ``rgbnomore_tpu``
(top-level names, compared whole) is loaded once the window has closed.

A run writes only inside the checkout and the temporary directory: the
port's kernels build into ``rgbnomore_tpu_torch/_build/`` (the first run in
a checkout compiles them, about a minute), and a traced run writes its
profiler trace (tens of MB) into ``TMPDIR`` and deletes it.  Nothing is
written elsewhere, under ``/dev/shm`` or to a fixed ``/tmp`` path.
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

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "rgbnomore_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules (the part of
    each name before its first dot, compared whole)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from cell import run_cell
    from manifest import Manifest

    man = Manifest()
    chips = man.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    if chips == 1:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        run = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                       t_start=T_START, chips=chips, manifest=man)
        print("setup " + ", ".join(f"{k} {v:.3f} s" for k, v in run.setup_parts.items()),
              file=sys.stderr)
        result = run.result()
        found = forbidden_modules()
    else:
        from ranks import run_ranks

        result, found, error = run_ranks(chips, workload=args.workload, seed=args.seed,
                                         seconds=args.seconds, trace=bool(args.trace),
                                         t_start=T_START, device="cuda")
        if error:
            print(f"portbench: {error}", file=sys.stderr)
            return 4
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
