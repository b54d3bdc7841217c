"""Each cell's set-up, window and check at a small size on the CPU, through
the harness's functions; the command's refusal without a card; the shape
of BENCHMARK.json."""
import json
import re
from pathlib import Path

import pytest

from hddbench import run as harness
from hddbench.tests.conftest import SMALL

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _cell_metrics(cell, kind):
    return [m for m in SPEC[kind] if cell in m.get("workloads", [cell])]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_runs_at_small_size(cell, trace, cpu):
    result = harness.run_cell(cell, 2 ** 31 + 17, 1.0, bool(trace), cpu, overrides=SMALL[cell])
    assert list(result)[-1] == "check"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in result
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in _cell_metrics(cell, kind)}
    if trace:  # the device's readings need the card's trace
        want -= {m["name"] for m in SPEC["per_layer"] if m["source"] == "device_trace"}
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert want <= set(result["metrics"])
    for m in result["metrics"].values():
        assert m["value"] == m["value"] and m["value"] >= 0
    assert all(set(c) == {"value", "limit"} for c in result["check"].values())


def test_same_seed_same_inputs(cpu):
    from hddbench.traffic import lognormal_field, mu_uniform

    wl = json.loads((ROOT / "hddbench/workloads/spe10_m1.b8.json").read_text())
    a, b = (lognormal_field.Traffic(wl["traffic"], 2 ** 31 + 5, cpu) for _ in range(2))
    assert all(bool((a.next() == b.next()).all()) for _ in range(3))
    wl = json.loads((ROOT / "hddbench/workloads/thermalblock_2x2.snapshots.json").read_text())
    a, b = (mu_uniform.Traffic(wl["traffic"], 2 ** 33 + 1) for _ in range(2))
    mus = [a.next() for _ in range(32)]
    assert all((m == b.next()).all() for m in mus)
    assert all(((m >= 0.1) & (m <= 1.0)).all() for m in mus)
    assert len({tuple(m) for m in mus}) == 32  # a fresh mu for every solve


@pytest.mark.parametrize("k", [1, 2, 7, 16])
def test_mu_is_uniform(k):
    """Over seeds, the k-th solve's mu is uniform in [0.1, 1]^4: each
    component's mean and deciles are those of U[0.1, 1]."""
    import numpy as np

    from hddbench.traffic import mu_uniform

    wl = json.loads((ROOT / "hddbench/workloads/thermalblock_2x2.snapshots.json").read_text())
    mus = []
    for seed in range(2 ** 31, 2 ** 31 + 4000):
        t = mu_uniform.Traffic(wl["traffic"], seed)
        for _ in range(k):
            mu = t.next()
        mus.append(mu)
    mus = np.array(mus)
    assert np.allclose(mus.mean(0), 0.55, atol=0.015)
    assert np.allclose(np.percentile(mus, [10, 50, 90], axis=0).T, [0.19, 0.55, 0.91],
                       atol=0.025)


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(harness.torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "spe10_m1.b8", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    bench = ROOT / "hddbench"
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and all(k in cfg for k in c["reduced"])
        assert (bench / "entries" / f"{cfg['entry']}.py").is_file()
        assert (bench / "reference" / f"{cfg['reference']}.py").is_file()
    for w in SPEC["workloads"]:
        wl = json.loads((bench / "workloads" / f"{w['name']}.json").read_text())
        assert (bench / "traffic" / f"{wl['generator']}.py").is_file()
        assert w["traffic"] == wl["generator"] and len(w["why"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and (bench / "metrics" / f"{m['name']}.py").is_file()
    assert 0.01 <= min(m["bound"] for m in SPEC["end_to_end"])
    assert max(m["bound"] for m in SPEC["end_to_end"]) <= 0.25
