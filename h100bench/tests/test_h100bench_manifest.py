"""BENCHMARK.json against the benchmark's contract and against the files
the harness finds by name."""

import importlib.util
import json
import re

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def metric_module(name):
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_paths_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) and not p.startswith("/") and ".." not in p
                                                 for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and all(text_ok(w) for w in b["command"])
    assert (ROOT / b["command"][1]).is_file() and b["command"][1].startswith(tuple(p + "/" for p in b["paths"]))
    assert len(json.dumps(b).encode()) <= 64 * 1024


def test_names_units_and_text():
    b = bench()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in b[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), group
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m["name"]
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and text_ok(w["why"])
    for c in b["configs"]:
        assert text_ok(c["source"]) and text_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in b["per_layer"]:
        assert text_ok(m["layer"])
    every = [e["name"] for g in ("configs", "workloads", "end_to_end", "per_layer") for e in b[g]]
    assert len(every) == len(set(every))


def test_entries_have_only_the_contracts_keys():
    b = bench()
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in b["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in b["workloads"])
    e2e = {"name", "unit", "better", "bound", "source"}
    assert all(e2e <= set(m) <= e2e | {"workloads"} for m in b["end_to_end"])
    pl = {"name", "unit", "better", "source", "layer", "moves"}
    assert all(pl <= set(m) <= pl | {"workloads"} for m in b["per_layer"])


def test_configs_and_cells():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    assert 1 <= len(configs) <= 24 and 1 <= len(b["workloads"]) <= 24
    for c in configs.values():
        assert c["file"].startswith("h100bench/") and (ROOT / c["file"]).is_file()
        with open(ROOT / c["file"]) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    assert {w["config"] for w in b["workloads"]} == set(configs)
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(b["workloads"])
    for w in b["workloads"]:
        assert w["chips"] == 1, w["name"]
        with open(BENCH / "workloads" / f"{w['name']}.json") as f:
            cell = json.load(f)
        assert {k: cell[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert (BENCH / "drivers" / f"{cell['driver']}.py").is_file()
        assert cell["limits"] and all(v > 0 for v in cell["limits"].values())


def test_metrics_and_their_readers():
    b = bench()
    cells = [w["name"] for w in b["workloads"]]
    reports = {c: set() for c in cells}
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128
    setup = [m for m in b["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0] and setup[0]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        for c in m.get("workloads", cells):
            reports[c].add(m["name"])
    for c, names in reports.items():
        assert "setup_s" in names and len(names) >= 2, c
    has_layer = {c: 0 for c in cells}
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        for c in m.get("workloads", [c for c in cells if m["moves"] in reports[c]]):
            assert m["moves"] in reports[c], (m["name"], c)
            has_layer[c] += 1
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(has_layer.values()), has_layer
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(metric_module(m["name"]).read), m["name"]


def test_run_seconds_fit_the_check_with_24_cells():
    rs = bench()["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_.-]+$", p.name), p
