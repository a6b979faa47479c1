"""BENCHMARK.json against the benchmark's contract, and the files it names
against the harness that finds them by name."""

import json
import math
import re
from pathlib import Path

import pytest

from perfbench import spec

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(_text(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for w in cmd[1:]:
        assert not w.startswith("/") and ".." not in w
        if (ROOT / w).exists():
            assert any(w.startswith(p + "/") for p in paths), w


def test_names_units_and_keys():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        extra = {"workloads"}
        base = {"name", "unit", "better", "source"}
        if m in BENCH["end_to_end"]:
            base |= {"bound"}
        else:
            base |= {"layer", "moves"}
        assert base <= set(m) <= base | extra, m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for item in BENCH["configs"] + BENCH["workloads"] + \
            BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(item["name"]), item["name"]
        assert item["name"] not in seen
        seen.add(item["name"])


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["source"].startswith("https://") and _text(c["source"])
        assert _text(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_cells():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(set(pairs)) == len(pairs)
    four = [w for w in cells if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in cells)
    assert len(four) <= max(1, len(cells) // 4)
    for w in cells:
        assert _text(w["why"])
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (spec.HERE / "limits" / f"{w['name']}.json").exists()
        c = spec.cell(w["name"], BENCH)
        kind = c.traffic["kind"]
        assert (spec.HERE / f"{kind}_run.py").exists()
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer, w["name"]


def test_end_to_end_metrics():
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        for cell in m.get("workloads", []):
            assert cell in CELLS


def test_per_layer_metrics():
    assert 1 <= len(BENCH["per_layer"]) <= 128
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _text(m["layer"])
        assert m["moves"] in E2E
        assert (spec.HERE / "metrics" / f"{m['name']}.py").exists()
        moved = E2E[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"]
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    # a layer's metrics give its name letter for letter
    assert all(len(v) == 1 for v in layers.values()), layers


def test_every_roofline_has_a_whole_step_share_beside_it():
    for m in BENCH["per_layer"]:
        if not m["name"].split(".")[0].endswith("_roofline"):
            continue
        mfu = [x for x in BENCH["per_layer"] if "mfu" in x["name"]
               and x["moves"] == m["moves"]]
        assert mfu, m["name"]
        assert set(m.get("workloads", CELLS)) <= set(
            mfu[0].get("workloads", CELLS))


def test_run_seconds_fits_a_full_check_at_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", sorted(CELLS))
def test_each_cell_reads_its_files(name):
    c = spec.cell(name)
    assert c.config["name"] == CELLS[name]["config"]
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    lim = json.loads((spec.HERE / "limits" / f"{name}.json").read_text())
    assert lim["limits"] and all(
        math.isfinite(v) and v > 0 for v in lim["limits"].values())


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH["paths"]:
        for f in Path(ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or f.is_dir():
                continue
            rel = str(f.relative_to(ROOT))
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel
