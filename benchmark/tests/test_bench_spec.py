"""BENCHMARK.json keeps to the rules of its format (names, units, sizes, the time a
full check takes), and every name in it finds its file: a configuration, a traffic
mix with its driver, a limits file, a reader for each per-layer metric."""

import json
import re

import pytest

from benchmark import common

SPEC = common.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(SPEC) == KEYS
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= len(SPEC["configs"]) <= 24 and 1 <= len(SPEC["workloads"]) <= 24


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(group):
    names = [e["name"] for e in SPEC[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_each_configuration_is_used_and_has_its_file():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["file"].startswith("benchmark/configs/")
        cfg = common.load_json(common.ROOT / c["file"])
        assert all(k in cfg for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]


def test_each_cell_finds_its_files():
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        entry, cfg, traffic, limits = common.cell(w["name"])
        assert (common.BENCH_DIR / "drivers" / f"{traffic['driver']}.py").is_file()
        assert limits and all(lim["lower"] < lim["limit"] < lim["upper"]
                              for lim in limits.values())


def test_metrics_keep_to_the_format():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    cells = [w["name"] for w in SPEC["workloads"]]
    for w in cells:
        reported = [m for m in SPEC["end_to_end"] if w in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(w in m.get("workloads", cells) for m in SPEC["per_layer"])
    for m in SPEC["per_layer"]:
        assert (common.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        for w in m.get("workloads", cells):
            assert w in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_each_configuration_finds_its_family_and_norm():
    from benchmark.reference import models

    for c in SPEC["configs"]:
        arch = common.load_json(common.ROOT / c["file"])["architecture"]
        assert (common.BENCH_DIR / "reference" / "families" / f"{arch['family']}.py").is_file()
        fam = models.family(arch)
        assert callable(fam.forward) and callable(fam.macs)
        if "norm" in arch:
            assert (common.BENCH_DIR / "reference" / "norms" / f"{arch['norm']}.py").is_file()


@pytest.mark.parametrize("path", sorted((common.BENCH_DIR / "metrics").glob("*.py")),
                         ids=lambda p: p.stem)
def test_each_reader_names_functions_the_port_has(path):
    import importlib

    from benchmark import run

    mod = run._reader(path.stem)
    assert callable(mod.read)
    for module_name, attr, note in getattr(mod, "PATCHES", []):
        assert callable(getattr(importlib.import_module(module_name), attr)) and callable(note)
