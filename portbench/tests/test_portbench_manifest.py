"""BENCHMARK.json against the benchmark's contract: names, units, the
files each entry names, which cell reports which metric."""

import json
import re

import pytest

from manifest import BENCH_DIR, Manifest

MAN = Manifest()
DATA = MAN.data
E2E = {m["name"]: m for m in DATA["end_to_end"]}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TEXT_RE = re.compile(r"^[^\t\n]{1,200}$")
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert DATA["command"] == ["python3", "portbench/run.py"]
    assert DATA["paths"] == ["portbench"]
    assert isinstance(DATA["run_seconds"], int) and 1 <= DATA["run_seconds"] <= 51
    assert len(json.dumps(DATA)) < 64 * 1024


def test_check_budget_fits_with_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (DATA["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_plain(section):
    names = [e["name"] for e in DATA[section]]
    assert len(names) == len(set(names))
    assert all(NAME_RE.match(n) for n in names), names


def test_configs_are_files_under_paths_and_used():
    used = {w["config"] for w in DATA["workloads"]}
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and c["name"] in used
        assert TEXT_RE.match(c["why"]) and TEXT_RE.match(c["source"])
        cfg = MAN.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert cfg["compute_dtype"] in ("float32", "bf16")
        kinds = {MAN.driver(MAN.traffic(w["traffic"])["driver"]).KIND
                 for w in DATA["workloads"] if w["config"] == c["name"]}
        assert kinds <= set(cfg["limits"]) <= {"train", "eval"}


def test_every_cell_finds_its_config_traffic_and_metrics():
    pairs = set()
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT_RE.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cfg = MAN.config(w["config"])
        assert MAN.driver(MAN.traffic(w["traffic"])["driver"]).KIND in ("train", "eval")
        assert callable(MAN.wire(cfg["wire"]).decode)
        e2e = {m["name"] for m in MAN.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = MAN.per_layer(w["name"])
        assert layers, w["name"]
        for m in layers:
            assert m["moves"] in e2e
            assert callable(MAN.reader(m["name"]))


def test_metrics_fields():
    for m in DATA["end_to_end"]:
        assert UNIT_RE.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert E2E["setup_s"]["bound"] == 0.25
    for m in DATA["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT_RE.match(m["unit"]) and m["source"] in SOURCES
        assert TEXT_RE.match(m["layer"]) and m["moves"] in E2E
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_at_most_a_quarter_of_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in DATA["workloads"])
    assert four <= max(1, len(DATA["workloads"]) // 4)
