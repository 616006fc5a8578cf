"""A configuration, a traffic mix, a cell and a per-layer metric are added
by new files and new entries of BENCHMARK.json alone."""

import json
import os
import shutil

import pytest

from benchmark import harness

from tiny import run, tiny_cell


def test_new_files_and_entries_are_found(tmp_path):
    root = str(tmp_path)
    shutil.copytree(harness.HERE, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    here = os.path.join(root, "benchmark")
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    # a configuration: the resnet34 backbone, a file of its own
    with open(os.path.join(here, "configs", "egotap-unrealego-r18.json")) as f:
        cfg = json.load(f)
    cfg.update(name="egotap-unrealego-r34", model_name="resnet34")
    with open(os.path.join(here, "configs", "egotap-unrealego-r34.json"),
              "w") as f:
        json.dump(cfg, f)
    # a traffic mix: batches of 2, read by a driver of a new kind (here
    # the serving driver under another name)
    with open(os.path.join(here, "traffic", "serve-b2.json"), "w") as f:
        json.dump({"kind": "probe", "batch": 2, "pool": 3, "warmup": 1,
                   "trace_units": 2, "check_slots": 1}, f)
    with open(os.path.join(here, "drivers", "probe.py"), "w") as f:
        f.write("from benchmark.drivers.serve import Driver, TRAFFIC\n")
    # a per-layer metric: a reader of its own
    with open(os.path.join(here, "metrics", "requests.probe.py"), "w") as f:
        f.write("def read(run):\n    return float(run.traced_units)\n")
    # limits of the new cell
    with open(os.path.join(here, "limits", "r34.serve-b2.json"), "w") as f:
        json.dump({"limits": {"pose_max": 1.0}}, f)
    bench["configs"].append({"name": "egotap-unrealego-r34",
                             "source": "https://github.com/tho-kn/EgoTAP",
                             "file": "benchmark/configs/egotap-unrealego-r34"
                                     ".json", "reduced": [], "why": "probe"})
    bench["workloads"].append({"name": "r34.serve-b2",
                               "config": "egotap-unrealego-r34",
                               "traffic": "serve-b2", "chips": 1,
                               "why": "probe"})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_pairs_per_s":
            m["workloads"].append("r34.serve-b2")
    bench["per_layer"].append({"name": "requests.probe", "unit": "req",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "serve_pairs_per_s",
                               "workloads": ["r34.serve-b2"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    cell = tiny_cell("r34.serve-b2", root)
    assert cell.config["model_name"] == "resnet34"
    assert cell.traffic["batch"] == 2
    assert [m["name"] for m in cell.per_layer] == ["requests.probe"]
    res = run(cell, trace=True)
    assert res["metrics"]["requests.probe"]["value"] == 2.0
    res = run(cell)
    assert set(res["metrics"]) == {"serve_pairs_per_s", "setup_s"}
    assert res["correct"]


def test_a_traffic_key_no_driver_reads_is_refused():
    cell = tiny_cell("r18.serve-b32")
    cell.traffic["clients"] = 4
    with pytest.raises(ValueError, match="clients"):
        harness.driver_for(cell)
    del cell.traffic["clients"], cell.traffic["warmup"]
    with pytest.raises(ValueError, match="warmup"):
        harness.driver_for(cell)
