"""``BENCHMARK.json`` and the files it names.

A cell (``workloads`` entry) names a configuration and a traffic mix; each is
found by name: ``configs/<config>.json`` (the configuration's ``file`` in the
manifest), ``traffic/<traffic>.json``, and each per-layer metric's reader
``metrics/<metric>.py``.  The traffic names the driver that runs the
program's entry in the window, ``drivers/<driver>.py``; the configuration's
``wire`` section names the rows' transfer and format, ``wires/<transfer>.
<format>.py``.  A later change adds a configuration, a mix, a metric, a
driver or a wire as new files and new entries, and edits none of these.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import re
from pathlib import Path

__all__ = ["BENCH_DIR", "CONFIG_KEYS", "Manifest", "load"]

BENCH_DIR = Path(__file__).resolve().parent
CONFIG_KEYS = {"name", "source", "what", "preset", "overrides", "compute_dtype", "control",
               "model", "train", "wire", "reference_block", "limits", "reduced", "assumed"}


@functools.lru_cache(maxsize=None)
def load(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark's folder."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} module {name!r} ({path} is missing)")
    module_name = f"pb_{kind}_" + re.sub(r"[.-]", "_", name)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Manifest:
    """The manifest at ``path`` (default: ``BENCHMARK.json`` beside this
    folder)."""

    def __init__(self, path: Path | None = None, traffic_dir: Path | None = None):
        self.path = Path(path) if path else BENCH_DIR.parent / "BENCHMARK.json"
        self.root = self.path.parent
        self.traffic_dir = Path(traffic_dir) if traffic_dir else BENCH_DIR / "traffic"
        self.data = json.loads(self.path.read_text())

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.path}")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                cfg = json.loads((self.root / c["file"]).read_text())
                unknown = sorted(set(cfg) - CONFIG_KEYS)
                if unknown:
                    raise ValueError(f"{c['file']}: the harness takes no keys {unknown}")
                return cfg
        raise KeyError(f"no configuration {name!r} in {self.path}")

    def traffic(self, name: str) -> dict:
        return json.loads((self.traffic_dir / f"{name}.json").read_text())

    @staticmethod
    def _applies(metric: dict, workload: str) -> bool:
        return "workloads" not in metric or workload in metric["workloads"]

    def end_to_end(self, workload: str) -> list[dict]:
        return [m for m in self.data["end_to_end"] if self._applies(m, workload)]

    def per_layer(self, workload: str) -> list[dict]:
        return [m for m in self.data["per_layer"] if self._applies(m, workload)]

    @staticmethod
    def reader(metric: str):
        """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
        return load("metrics", metric).read

    @staticmethod
    def driver(name: str):
        """The driver module ``drivers/<name>.py``."""
        return load("drivers", name)

    @staticmethod
    def wire(wire: dict):
        """The wire module of a configuration's ``wire`` section,
        ``wires/<transfer>.<format>.py``."""
        return load("wires", f"{wire['transfer']}.{wire['format']}")
