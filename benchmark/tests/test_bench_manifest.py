"""BENCHMARK.json against the rules of its format, and every file it
names found by name."""
import json
import math
import re

from cnbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def bench():
    return manifest.manifest()


def test_keys_and_sizes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert len(json.dumps(b)) <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) for p in b["paths"])
    assert all(not p.startswith("/") and ".." not in p for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128


def test_check_fits_with_24_cells():
    b = bench()
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_text():
    b = bench()
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[key]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in b["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200


def test_entry_keys():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    b = bench()
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in b["end_to_end"])
    for w in b["workloads"]:
        e2e = [m["name"] for m in manifest.metrics_for(w["name"], "end_to_end", b)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_for(w["name"], "per_layer", b)


def test_per_layer_cells_report_what_they_move():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)


def test_rooflines_and_mfu_are_named_and_in_percent():
    for m in bench()["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
        if "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_files_found_by_name():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = manifest.config(c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        reference = manifest.BENCH_DIR / "reference"
        assert (reference / "backbones" / f"{cfg['backbone']}.py").is_file()
        assert (reference / "necks" / f"{cfg.get('neck', 'FPN').lower()}.py").is_file()
    for w in b["workloads"]:
        assert w["config"] in configs
        assert manifest.traffic(w["traffic"])["kind"] in ("offline", "train")
        limits = manifest.limits(w["name"])
        assert limits and all(v > 0 for v in limits.values())
    for m in b["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]))
    used = {w["config"] for w in b["workloads"]}
    assert used == set(configs)


def test_reduced_names_no_width():
    for c in bench()["configs"]:
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank", "_size", "channels", "width"))


def test_limits_lie_between_their_readings():
    for w in bench()["workloads"]:
        data = json.load(open(manifest.BENCH_DIR / "limits" / f"{w['name']}.json"))
        for name, limit in data["limits"].items():
            r = data["readings"][name]
            assert r["lower"] < limit < r["upper"]
            assert r["upper"] >= 3 * r["lower"]
            assert math.log(limit / r["lower"]) > 0 and math.log(r["upper"] / limit) > 0
