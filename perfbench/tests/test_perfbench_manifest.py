"""BENCHMARK.json against the contract the harness is built to: names and
units, the cells' files, every metric's cells and reader, one card a
cell."""

import json
import re

import perfbench_testing as PT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = json.loads((PT.ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in MANIFEST["workloads"]}
HERE = PT.ROOT / "perfbench"


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["perfbench"]
    assert MANIFEST["command"] == ["python3", "-m", "perfbench.run"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((PT.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names))
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_on_one_card_with_its_files():
    assert len(CELLS) == len(MANIFEST["workloads"])
    for name, w in CELLS.items():
        assert w["chips"] == 1
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (HERE / "limits" / f"{name}.json").is_file()
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_configuration_has_a_cell_and_a_builder():
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        conf = json.loads((PT.ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert (HERE / "scenes" / f"{conf['builder']}.py").is_file()


def test_every_metric_has_cells_a_reader_and_moves_a_reported_metric():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in MANIFEST["per_layer"]:
        assert m["workloads"], m["name"]
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS)), m["name"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["source"] == "device_trace"
    for cell in CELLS:
        reported = [m for m in MANIFEST["end_to_end"] if cell in m.get("workloads", CELLS)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in MANIFEST["per_layer"])


def test_every_traffic_takes_the_programs_automatic_choices():
    from montecarlopathtracer_tpu_torch.cli import resolve_choices

    files = {c["name"]: c["file"] for c in MANIFEST["configs"]}
    for w in MANIFEST["workloads"]:
        conf = json.loads((PT.ROOT / files[w["config"]]).read_text())
        tr = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        auto = resolve_choices(conf["triangles"], mode=tr["mode"],
                               spp_per_pass=tr["spp_per_pass"])
        assert auto["intersector"] == tr["intersector"], w["name"]
        assert auto["chunk_cull"] == tr["chunk_cull"] and auto["regen"] == tr["regen"]
        assert not auto["ray_sort"] and auto["ray_chunk"] == 0


def test_layers_are_named_alike():
    for m in MANIFEST["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    rooflines = {m["layer"] for m in MANIFEST["per_layer"] if m["name"].endswith("_roofline")}
    assert len(rooflines) == 1
