"""Every file of the benchmark parses and is found by name, and
BENCHMARK.json keeps to the contract's shape."""

import json
import re

import pytest

from portbench import harness

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        # each lists the cells that report it (harness.reports)
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for k in ("end_to_end", "per_layer") for m in BENCH[k])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.workload["kind"] in ("train", "serve")
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}
    assert c.per_layer, "every cell reports a per-layer metric"
    assert set(c.workload["limits"]) and all(v > 0 for v in c.workload["limits"].values())
    # each reported per-layer metric moves an end-to-end metric of this cell
    assert {m["moves"] for m in c.per_layer} <= {m["name"] for m in c.end_to_end}
    __import__(f"portbench.traffic.{c.workload['kind']}")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.load_reader(metric))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_lists_what_it_cut(config):
    body = harness.load_json(harness.ROOT / config["file"])
    # BENCHMARK.json's reduced lists every key changed from the source: the
    # file's cuts and the values it takes from another published source
    assert sorted(config["reduced"]) == sorted({*body["reduced"], *body.get("changed", {})})
    assert harness.config_problems(config["name"], body) == []


def _departing(**changed):
    """voc_dp8_bf16's file as a configuration of its own that departs from
    the preset: the U-Net-256 generator of pix2pix in place of the ResNet."""
    body = harness.load_json(harness.BENCH_DIR / "configs" / "voc_dp8_bf16.json")
    return {**body, "preset": "voc_dp8_bf16", "gen_net": "unet_256", "changed": changed}


UNET_256 = {"published": "resnet_9blocks", "here": "unet_256",
            "source": "arXiv:1611.07004 section 6.1.1; the reference repo's "
                      "define_Gen(netG='unet_256')"}


def test_a_config_may_depart_from_its_preset():
    assert harness.config_problems("voc_dp8_unet256", _departing(gen_net=UNET_256)) == []


@pytest.mark.parametrize("changed", [
    {},                                                         # gen_net not listed
    {"gen_net": {**UNET_256, "source": " "}},                   # listed with no source
    {"gen_net": {**UNET_256, "published": "resnet_6blocks"}},   # not the preset's value
    {"gen_net": {**UNET_256, "here": "unet_128"}},              # not the file's value
], ids=["unlisted", "no_source", "not_published", "not_here"])
def test_a_departure_is_refused_unless_listed_whole(changed):
    assert harness.config_problems("voc_dp8_unet256", _departing(**changed))


def test_a_width_is_never_cut():
    body = harness.load_json(harness.BENCH_DIR / "configs" / "voc_dp8_bf16.json")
    body = {**body, "ngf": 32,
            "reduced": {**body["reduced"], "ngf": {"published": 64, "here": 32, "why": "-"}}}
    assert harness.config_problems("voc_dp8_bf16", body) == ["ngf: a width, never cut"]
