"""BENCHMARK.json keeps to the benchmark contract's shape and characters,
and every cell's files are found by name."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for word in cmd:
        assert not word.startswith("/") and ".." not in word
        if (ROOT / word).is_file():
            assert any(word.startswith(p + "/") for p in paths)


@pytest.mark.parametrize("entry", METRICS + BENCH["workloads"]
                         + BENCH["configs"], ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.fullmatch(entry["name"])
    if "unit" in entry:
        assert UNIT.fullmatch(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.fullmatch(entry[key])
    for key in ("why", "layer"):
        if key in entry:
            assert line(entry[key])
    if "file" in entry:
        assert line(entry["source"])


def test_names_are_unique():
    for group in (METRICS, BENCH["workloads"], BENCH["configs"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_setup_another_metric_and_a_layer():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for cell in CELLS:
        c = harness.load_cell(cell)
        e2e = {m["name"] for m in c.end_to_end()}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = c.per_layer()
        assert layers
        for m in layers:
            assert m["moves"] in e2e


def test_per_layer_metrics_list_cells_that_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        cells = e2e[m["moves"]].get("workloads", CELLS)
        assert m["workloads"] and set(m["workloads"]) <= set(cells)
    layers: dict[str, set] = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert all(line(k) for k in layers)


def test_every_configuration_is_used_and_its_file_holds_it():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    c = harness.load_cell(cell)
    here = harness.HERE
    assert (here / "traffic" / f"{c.kind}.py").is_file()
    assert (here / "counts" / f"{c.config['name']}.py").is_file()
    for m in c.per_layer():
        reader = harness.load_module(here / "metrics" / f"{m['name']}.py",
                                     "reader")
        assert callable(reader.read)
    counts = c.counts()
    terms = (counts.step_terms if c.kind == "train" else counts.call_terms)(
        c.config, c.mix)
    assert terms and all(f > 0 for _, f, _ in terms)
    assert counts.kernel_groups(c.config, c.mix)
    assert c.limits and all(v > 0 for v in c.limits.values())


@pytest.mark.parametrize("cell", CELLS)
def test_configuration_is_the_ports_preset(cell):
    mc, preset = harness.model_config(harness.load_cell(cell))
    assert mc.time_len == harness.load_cell(cell).mix["time_len"]


def test_a_changed_preset_value_is_refused():
    c = harness.load_cell(CELLS[0])
    c.config["model"] = dict(c.config["model"], noise=0.5)
    with pytest.raises(harness.RunError, match="noise"):
        harness.model_config(c)


def test_a_full_check_fits_its_time():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
