"""The PyTorch port's utilities against the JAX package's: configuration
merge and sections, the VTU writers' text (triangles, quads, P2 as quadratic
triangles, the higher-order Lagrange types, cell data) equal to the
reference writer's, the logger factory and the timed logger, the phase
spans of the port's record, and the ``torch.profiler`` trace with
annotations."""
import json
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from dune_hdd_tpu.grid import structured as jg  # noqa: E402
from dune_hdd_tpu.ops import spaces as jspaces  # noqa: E402
from dune_hdd_tpu.utils import vtk as jvtk  # noqa: E402
from dune_hdd_tpu_torch.grid import structured as tg  # noqa: E402
from dune_hdd_tpu_torch.ops import spaces as tspaces  # noqa: E402
from dune_hdd_tpu_torch.utils import vtk as tvtk  # noqa: E402
from dune_hdd_tpu_torch.utils.config import Configuration  # noqa: E402
from dune_hdd_tpu_torch.utils.logging import (  # noqa: E402
    TimedLogger, create_logger, reset_timings, timed, timings)
from dune_hdd_tpu_torch.utils.profiling import (  # noqa: E402
    annotate, profile_report, recording, trace)
from torch_threads import one_torch_thread  # noqa: E402,F401


def test_timed_records_phases(capsys):
    """``timed`` opens spans of the record while recording, and keeps
    nothing otherwise (its log lines are written either way)."""
    reset_timings()
    log = create_logger({"info": True}, "test_timed_phases")
    with timed("phase.off", log):
        pass
    assert timings() == {}
    with recording():
        with timed("phase.a"):
            pass
        with timed("phase.a"):
            pass
        with timed("phase.b", log, sync="cpu"):
            pass
    t = timings()
    assert len(t["phase.a"]) == 2 and len(t["phase.b"]) == 1 and "phase.off" not in t
    assert all(v >= 0 for v in t["phase.a"])
    out = capsys.readouterr().out
    assert "phase.b...\n" in out and "phase.b... done (took " in out
    reset_timings()
    assert timings() == {}


def test_timed_logger_emits(capsys):
    log = TimedLogger("test_torch_timed_logger")
    log.info("hello")
    log.debug("hidden")
    log.warn("careful")
    out = capsys.readouterr().out
    assert "hello" in out and "s] " in out and "careful" in out and "hidden" not in out


def test_logger_flags(tmp_path):
    assert create_logger({"info": False}, "quiet_logger").level == logging.WARNING
    assert create_logger({"debug": True}, "debug_logger").level == logging.DEBUG
    assert create_logger(None, "info_logger").level == logging.INFO
    path = tmp_path / "run.log"
    log = create_logger({"file": True, "filename": str(path)}, "file_logger")
    log.info("to the file")
    for h in log.handlers:
        h.flush()
    assert "INFO to the file" in path.read_text()
    for h in list(log.handlers):
        h.close()
        log.removeHandler(h)


def test_config_merge_and_sections():
    a = Configuration({"grid.type": "cube", "grid.num_elements": [4, 4]})
    a.add(Configuration({"problem.type": "ESV2007"}))
    assert a["problem.type"] == "ESV2007"
    a.add(Configuration({"inner": 1}), sub_name="nested.deep")
    assert a["nested.deep.inner"] == 1
    cfg = Configuration.from_string("# comment\n[grid]\ntype = cube # trailing\n\nnum = 3\n")
    assert cfg["grid.type"] == "cube" and cfg["grid.num"] == 3
    assert cfg.get("grid.missing", 7) == 7 and cfg.has_key("grid.num")
    with pytest.raises(KeyError):
        cfg.sub("grid.type")


VTU_CASES = {  # name -> (cell type, order, continuous)
    "triangle_cg1": ("triangle", 1, True),
    "triangle_dg1": ("triangle", 1, False),
    "quad_cg1": ("quad", 1, True),
    "quad_dg1": ("quad", 1, False),
    "triangle_cg2": ("triangle", 2, True),
    "triangle_dg2": ("triangle", 2, False),
    "quad_cg2": ("quad", 2, True),
    "quad_dg2": ("quad", 2, False),
    "triangle_cg3": ("triangle", 3, True),
    "triangle_dg3": ("triangle", 3, False),
}


@pytest.mark.parametrize("name", list(VTU_CASES))
def test_vtu_text_equals_reference(name, tmp_path):
    cell_type, order, continuous = VTU_CASES[name]
    t_grid = tg.rectangle_grid((0, 0), (1, 1.5), (3, 2), cell_type)
    j_grid = jg.rectangle_grid((0, 0), (1, 1.5), (3, 2), cell_type)
    maker = "cg_space" if continuous else "dg_space"
    t_space = getattr(tspaces, maker)(t_grid, order, device="cpu")
    j_space = getattr(jspaces, maker)(j_grid, order)
    assert t_space.num_dofs == j_space.num_dofs
    u = np.arange(t_space.num_dofs, dtype=float) * 0.25 - 1.0
    t_path = tvtk.write_vtu(t_space, torch.tensor(u), str(tmp_path / "port" / name))
    j_path = jvtk.write_vtu(j_space, u, str(tmp_path / "reference" / name))
    assert t_path.endswith(".vtu") and os.path.isfile(t_path)
    with open(t_path) as a, open(j_path) as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("cell_type", ["triangle", "quad"])
def test_cell_data_vtu_text_equals_reference(cell_type, tmp_path):
    t_grid = tg.rectangle_grid((0, 0), (1, 1), (3, 3), cell_type)
    j_grid = jg.rectangle_grid((0, 0), (1, 1), (3, 3), cell_type)
    eta = np.linspace(0.0, 1.0, t_grid.num_cells)
    t_path = tvtk.write_cell_data_vtu(t_grid, {"eta": torch.tensor(eta), "one": np.ones(
        t_grid.num_cells)}, str(tmp_path / "port"))
    j_path = jvtk.write_cell_data_vtu(j_grid, {"eta": eta, "one": np.ones(j_grid.num_cells)},
                                      str(tmp_path / "reference"))
    with open(t_path) as a, open(j_path) as b:
        assert a.read() == b.read()


def test_profiler_trace_and_annotations(tmp_path):
    """``trace`` writes a Chrome trace that holds the annotation as an
    ``hdd::`` span; the annotation lands in the record; ``profile_report``
    aggregates and resets."""
    reset_timings()
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        with annotate("hot_phase"):
            float((torch.ones(64, 64) * 2.0).sum())
    path = os.path.join(logdir, "trace.json")
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "hdd::hot_phase" for e in events)
    assert "hot_phase" in timings()
    rep = profile_report(reset=True)
    assert "hot_phase" in rep and "calls" in rep
    assert timings() == {}
