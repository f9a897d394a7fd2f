"""Every cell of BENCHMARK.json resolves by name to its configuration, mix,
limits, family, reference and per-layer readers; a configuration, a mix and
a metric are added by adding files, editing none."""
import json
import shutil

import pytest

from portbench import compare, spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.cell(name)
    assert cell.config["name"] == cell.entry["config"]
    assert cell.mix["loop"] in ("train", "serve")
    assert cell.family.REFERENCE.param_shapes(cell.config)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert any(m["name"] != "setup_s" for m in cell.end_to_end)
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in cell.end_to_end}
    train = set(compare.NUMBERS)
    numbers = {"train": train | {f"{k}_per_f32" for k in train},
               "serve": {"node_gap"}}[cell.mix["loop"]]
    assert cell.limits and set(cell.limits) <= numbers


def test_configs_hold_their_reduced_keys():
    for c in BENCH["configs"]:
        with open(spec.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]


def test_a_cell_is_added_by_files(tmp_path):
    here = tmp_path / "portbench"
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(spec.HERE / d, here / d)
    cfg = json.loads((here / "configs" / "dense_knn_readme.json").read_text())
    cfg["name"] = "dense_knn_small"
    (here / "configs" / "dense_knn_small.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "train_b8.json").read_text())
    mix["batch"] = 64
    (here / "traffic" / "train_g64.json").write_text(json.dumps(mix))
    (here / "limits" / "dense_knn_small.train_g64.json").write_text(
        (here / "limits" / "dense_knn_readme.train_b8.json").read_text())
    (here / "metrics" / "blocks_read.train.py").write_text(
        "def read(reading):\n    return float(reading.units)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "dense_knn_small.train_g64",
                               "config": "dense_knn_small", "traffic": "train_g64",
                               "chips": 1, "why": "a test's dummy cell"})
    bench["per_layer"].append({"name": "blocks_read.train", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "train_edges_per_s",
                               "workloads": ["dense_knn_small.train_g64"]})
    cell = spec.cell("dense_knn_small.train_g64", bench, here=here)
    assert cell.mix["batch"] == 64 and cell.config["name"] == "dense_knn_small"
    assert [m["name"] for m in cell.per_layer] == ["blocks_read.train"]

    class R:
        units = 7

    assert spec.reader("blocks_read.train", here=here)(R()) == 7.0
