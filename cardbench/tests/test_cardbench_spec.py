"""``BENCHMARK.json`` and every file it names load, keep to the benchmark's
contract on names, units and keys, and agree with each other."""

from __future__ import annotations

import json
import math
import re

import pytest

from cardbench import bench, compare
from cardbench.inputs import dense_lm_shapes

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|"
                   r"_dim$|_rank$|head|expansion|experts_per_tok)")


def test_top_level_keys_and_size(spec):
    assert set(spec) == TOP
    assert len(bench.SPEC.read_bytes()) <= 64 * 1024
    assert 1 <= len(spec["command"]) <= 32
    assert all(1 <= len(w) <= 200 and "\t" not in w and "\n" not in w
               for w in spec["command"])
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in spec["paths"])
    assert spec["command"][1].startswith(tuple(spec["paths"]))


def test_run_seconds_fit_the_check_with_every_cell():
    spec = bench.spec()
    s = spec["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units(spec):
    names = [c["name"] for c in spec["configs"]] + \
        [w["name"] for w in spec["workloads"]] + \
        [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in spec["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_configs(spec):
    used = {w["config"] for w in spec["workloads"]}
    files = [c["file"] for c in spec["configs"]]
    assert len(files) == len(set(files))
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in spec["paths"]))
        cfg = bench.config(spec, c["name"])
        assert cfg["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
            assert key in cfg and key in cfg["reduced"]
        dense_lm_shapes(cfg)              # every size the drivers read


def test_workloads_and_their_files(spec):
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = bench.traffic(w["traffic"])
        bench.driver(traffic["driver"]).run        # the driver is there
        limits = bench.limits(w["name"])
        assert set(limits["numbers"]) <= set(compare.NUMBERS)
        for spec_ in limits["numbers"].values():
            assert math.isfinite(spec_["limit"]) and spec_["limit"] >= 0
    fours = sum(w["chips"] == 4 for w in spec["workloads"])
    assert fours <= max(1, len(spec["workloads"]) // 4)


def test_end_to_end_metrics(spec):
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for w in spec["workloads"]:
        reported = {m["name"] for m in bench.end_to_end(spec, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert bench.per_layer(spec, w["name"])


def test_per_layer_metrics_have_readers_and_move_a_reported_metric(spec):
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert callable(bench.reader(m["name"]).read)
        for w in m.get("workloads", []):
            reported = {x["name"] for x in bench.end_to_end(spec, w)}
            assert m["moves"] in reported, (m["name"], w)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_kinds_and_work_files_load():
    kinds = bench.kinds()
    assert len({k["kind"] for k in kinds}) == len(kinds)
    for k in kinds:
        assert k["patterns"] and all(p == p.lower() for p in k["patterns"])
    for name in ("attn_fwd", "attn_bwd"):
        assert callable(bench.work(name).work)
    peaks = bench.peaks()
    assert peaks["flops_per_s"]["bfloat16"] == 989e12
    assert peaks["bytes_per_s"] == 3.35e12


@pytest.mark.parametrize("path", sorted(bench.HERE.rglob("*.json")),
                         ids=lambda p: p.name)
def test_every_data_file_is_json(path):
    json.loads(path.read_text())
