"""BENCHMARK.json and every file it names, found by name, within the
manifest format's limits on names, units, bounds, cells and run length."""
import json
import math
import re

import pytest

from portbench import core
from portbench.yardstick.flops import Geometry

ROOT = core.ROOT
MAN = core.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CELLS = [w["name"] for w in MAN["workloads"]]
# published OpenCLIP widths and depths (model_configs/ViT-B-16.json, ViT-L-14.json)
PUBLISHED = {
    "ViT-B-16-colxlip": dict(embed_dim=512, image_size=224, patch_size=16, v_width=768,
                             v_layers=12, v_head_width=64, t_ctx=77, t_width=512,
                             t_layers=12, t_heads=8, vocab_size=49408),
    "ViT-L-14-colxlip": dict(embed_dim=768, image_size=224, patch_size=14, v_width=1024,
                             v_layers=24, v_head_width=64, t_ctx=77, t_width=768,
                             t_layers=12, t_heads=12, vocab_size=49408),
}


def text_ok(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_keys_and_command():
    assert set(MAN) == KEYS
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert 1 <= len(MAN["command"]) <= 32 and all(text_ok(w) for w in MAN["command"])
    assert (ROOT / MAN["command"][1]).is_file()
    assert any(MAN["command"][1].startswith(p + "/") for p in MAN["paths"])
    assert len(json.dumps(MAN, indent=2).encode()) <= 64 * 1024


def test_run_seconds_fit_a_full_check():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    names = [c["name"] for c in MAN["configs"]] + CELLS \
        + [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(c["name"] for c in MAN["configs"])) == len(MAN["configs"])
    assert len(set(CELLS)) == len(CELLS)
    metric_names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for n in names:
        assert NAME.match(n), n
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert text_ok(c["source"]) and text_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and text_ok(w["why"])
        assert w["chips"] in (1, 4)
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(CELLS) // 4)
    assert len({(w["config"], w["traffic"]) for w in MAN["workloads"]}) == len(CELLS)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert text_ok(m["layer"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert next(m for m in MAN["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e, per_layer = core.cell_metrics(MAN, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per_layer
    for m in per_layer:
        assert m["moves"] in names, (m["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    entry = next(w for w in MAN["workloads"] if w["name"] == cell)
    c = core.load_cell(cell, 1, 1.0, False)
    assert c.workload["config"] == entry["config"] == c.config["name"]
    assert c.workload["traffic"] == entry["traffic"] and c.chips == entry["chips"]
    assert hasattr(core.load_kind(c.kind), "Kind")
    assert hasattr(core.load_reference(c), "encode_reference")
    assert c.limits and all(v > 0 and math.isfinite(v) for v in c.limits.values())


@pytest.mark.parametrize("config", MAN["configs"], ids=lambda c: c["name"])
def test_configs_hold_the_published_shapes(config):
    path = ROOT / config["file"]
    assert any(config["file"].startswith(p + "/") for p in MAN["paths"])
    data = core.load_json(path)
    assert data["name"] == config["name"] and data["reduced"] == config["reduced"]
    assert data["source"] == config["source"]
    g = Geometry.from_model(data["model"])
    assert {k: getattr(g, k) for k in PUBLISHED[config["name"]]} == PUBLISHED[config["name"]]
    # the program's registry holds the same model, and every setting the
    # reference assumes
    from colxlip_tpu_torch.factory import model_config
    core.check_program_config(model_config(data["model_name"]), data["model"])


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_load_by_name(metric):
    reader = core.load_reader(metric["name"])
    assert callable(reader.read)


def test_files_under_paths_are_named_from_name_characters():
    for p in MAN["paths"]:
        for f in (ROOT / p).rglob("*"):
            rel = f.relative_to(ROOT).as_posix()
            if "__pycache__" in rel or ".pytest_cache" in rel:
                continue
            assert PATH.match(rel), rel
