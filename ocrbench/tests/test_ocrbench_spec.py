"""The harness finds each piece by name, and a new configuration, traffic
mix, per-layer metric and cell come in as new files and entries."""
import json
import os
import shutil

from ocrbench import spec
from conftest import ROOT


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_loads_by_name():
    b = _bench()
    for w in b["workloads"]:
        cell = spec.load(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["kind"] in ("pages", "lines")
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        for m in cell.per_layer:
            assert callable(spec.reader(m["name"]))
            assert m["moves"] in names
        assert any("limit" in v for v in cell.limits.values())


def test_configs_and_paths_follow_the_contract():
    b = _bench()
    assert b["paths"] == ["ocrbench"]
    for c in b["configs"]:
        assert c["file"].startswith("ocrbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}


def test_additions_need_no_edit(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    metric and a cell as new files plus new entries; every file that was
    there stays byte for byte."""
    root = tmp_path
    shutil.copytree(os.path.join(ROOT, "ocrbench"), root / "ocrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    before = {p: p.read_bytes() for p in (root / "ocrbench").rglob("*")
              if p.is_file()}
    cfg = json.loads((root / "ocrbench/configs/mbv3-db-svtr192.json")
                     .read_text())
    cfg["name"] = "mbv3-db-svtr192-b"
    (root / "ocrbench/configs/mbv3-db-svtr192-b.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((root / "ocrbench/traffic/scan-a4-300dpi.json")
                         .read_text())
    traffic["load"]["in_flight"] = 8
    (root / "ocrbench/traffic/scan-a4-depth8.json").write_text(
        json.dumps(traffic))
    (root / "ocrbench/metrics/answered_pages.py").write_text(
        "def read(run):\n    return float(run.pages) or None\n")
    (root / "ocrbench/limits/v5b-depth8.json").write_text(json.dumps(
        {"rec_gap": {"limit": 1e-3}}))
    b["configs"].append({"name": "mbv3-db-svtr192-b", "source": "x",
                         "file": "ocrbench/configs/mbv3-db-svtr192-b.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "v5b-depth8", "config": "mbv3-db-svtr192-b",
                           "traffic": "scan-a4-depth8", "chips": 1,
                           "why": "x"})
    b["per_layer"].append({"name": "answered_pages", "unit": "pages",
                           "better": "higher", "source": "program_counter",
                           "layer": "engine", "moves": "pages_per_s",
                           "workloads": ["v5b-depth8"]})
    b["end_to_end"][0]["workloads"].append("v5b-depth8")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load("v5b-depth8", root=str(root))
    assert cell.traffic["load"]["in_flight"] == 8
    assert cell.config["name"] == "mbv3-db-svtr192-b"
    assert [m["name"] for m in cell.per_layer] == ["answered_pages"]
    read = spec.reader("answered_pages", root=str(root))

    class R:
        pages = 3
    assert read(R()) == 3.0
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_a_loop_the_harness_cannot_drive_is_refused(tmp_path):
    """A traffic file asking for an open loop is refused, not run as the
    closed loop the harness drives."""
    import pytest
    root = tmp_path
    shutil.copytree(os.path.join(ROOT, "ocrbench"), root / "ocrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    traffic = json.loads((root / "ocrbench/traffic/scan-a4-300dpi.json")
                         .read_text())
    traffic["load"]["loop"] = "open"
    (root / "ocrbench/traffic/scan-a4-open.json").write_text(
        json.dumps(traffic))
    (root / "ocrbench/limits/v5-open.json").write_text(json.dumps(
        {"rec_gap": {"limit": 1e-3}}))
    b["workloads"].append({"name": "v5-open", "config": "mbv3-db-svtr192",
                           "traffic": "scan-a4-open", "chips": 1,
                           "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    with pytest.raises(ValueError, match="open"):
        spec.load("v5-open", root=str(root))
    assert spec.load("v5-scans", root=str(root)).traffic["load"][
        "loop"] == "closed"
