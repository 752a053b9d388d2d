"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding every cell, configuration, traffic mix and metric by name."""

import json
import re
import shutil
import types

import pytest

from benchmark.harness import core, trace
from benchmark.tests import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_manifest_keeps_the_contract():
    man = core.manifest()
    assert set(man) == KEYS["top"]
    assert man["command"] == ["python3", "benchmark/run.py"] and man["paths"] == ["benchmark"]
    assert 1 <= man["run_seconds"] <= 51
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in man[part]]
        assert len(names) == len(set(names)), part
        for e in man[part]:
            assert set(e) - {"workloads"} == KEYS[part] or set(e) == KEYS[part], e
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e and part in ("configs", "workloads", "per_layer"):
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k], (k, e)
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    names = {w["name"] for w in man["workloads"]}
    # one or four cards; four-card cells at most a quarter of the cells, rounded down, or one
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert all(w["chips"] in (1, 4) for w in man["workloads"])
    assert four <= max(1, len(names) // 4)
    assert len({(w["config"], w["traffic"]) for w in man["workloads"]}) == len(names)
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= names
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(man)) < 64 * 1024


@pytest.mark.parametrize("workload", cells.names(core))
def test_every_cell_resolves(workload):
    cells.check_resolves(core, workload)


def test_added_files_are_found(tmp_path, monkeypatch):
    """A later cell and per-layer metric arrive as new files (a traffic mix, a
    cell's limits, a reader) plus their entries in BENCHMARK.json; the
    harness lists them without an edit to any file under benchmark/."""
    shutil.copytree(core.BENCH, tmp_path / "benchmark")
    man = core.manifest()
    man["workloads"].append({"name": "dp_vae.replay.r2", "config": "dp_vae_64qam",
                             "traffic": "replay.r2", "chips": 1, "why": "a dummy cell"})
    man["per_layer"].append({"name": "dummy.count", "unit": "kernels", "better": "lower",
                             "source": "device_trace", "layer": "device", "moves": "symbols_per_s",
                             "workloads": ["dp_vae.replay.r2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    mix = json.loads((core.BENCH / "traffic" / "replay.r8.json").read_text())
    (tmp_path / "benchmark" / "traffic" / "replay.r2.json").write_text(json.dumps({**mix, "runs": 2}))
    shutil.copy(core.BENCH / "workloads" / "dp_vae.replay.r8.json",
                tmp_path / "benchmark" / "workloads" / "dp_vae.replay.r2.json")
    (tmp_path / "benchmark" / "metrics" / "dummy.count.py").write_text(
        "def read(t, cell):\n    return cell.mix['runs'] * float(len(t.ops)) or None\n")
    monkeypatch.setattr(core, "ROOT", tmp_path)
    monkeypatch.setattr(core, "BENCH", tmp_path / "benchmark")
    new = core.manifest()
    spec = core.cell_spec(new, "dp_vae.replay.r2")
    assert spec["mix"]["runs"] == 2
    names = [m["name"] for m in core.metrics_of(new, "dp_vae.replay.r2", trace=True)]
    assert "dummy.count" in names
    assert "dummy.count" not in [m["name"] for m in core.metrics_of(new, "dp_vae.replay.r8", True)]
    read = core.load_module(core.BENCH / "metrics" / "dummy.count.py", "m_dummy_count").read
    ran = types.SimpleNamespace(config=spec["config"], mix=spec["mix"], untraced={})
    assert read(trace.Summary(ops=[("k", 0.0, 1.0)]), ran) == 2.0  # the cell's own shapes
