"""The command-line entry point and configuration system of the PyTorch port
(``cli/``, ``utils/config.py``), mirroring ``tests/test_cli.py`` with
``--device cpu``, against the JAX package's:

* value parsing and the config round trip; configs written by either
  package load in the other, and every example's default config text equals
  the reference writer's (and the digests ``chip_smoke.py`` checks on the
  card);
* write-config-then-solve for every example, the thermalblock's parameter
  blocks with VTU output, ``rb``, both studies (the FVCA7 poster rows within
  2e-3 of the recorded table);
* the façades' discretizations at the default configs equal the
  reference's (operator, rhs and products per affine component, 1e-12
  relative);
* the reference's interval façade case, the ALU-conforming grid provider
  and ``--device``'s default raising without a card.
"""
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from dune_hdd_tpu.cli import examples as jex  # noqa: E402
from dune_hdd_tpu.utils.config import Configuration as JConfiguration  # noqa: E402
from dune_hdd_tpu_torch.cli import examples as tex  # noqa: E402
from dune_hdd_tpu_torch.cli.main import fvca7_poster_study, main  # noqa: E402
from dune_hdd_tpu_torch.studies.expectations import expected_results  # noqa: E402
from dune_hdd_tpu_torch.utils.config import Configuration, parse_value  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = {"cg": "LinearellipticExampleCG", "swipdg": "LinearellipticExampleSWIPDG",
            "block-swipdg": "LinearellipticExampleBlockSWIPDG",
            "thermalblock": "ThermalblockExample"}


def cli(*argv):
    return main(list(argv) + ["--device", "cpu"])


def test_parse_values():
    assert parse_value("42") == 42
    assert parse_value("0.5") == 0.5
    assert parse_value("true") is True
    assert parse_value("[4 4 1]") == [4, 4, 1]
    assert parse_value("[0.95 1.10; 0.30 0.45]") == [[0.95, 1.10], [0.30, 0.45]]
    assert parse_value("stuff.grid.provider.cube") == "stuff.grid.provider.cube"


def test_config_roundtrip(tmp_path):
    cfg = Configuration()
    cfg["grid.type"] = "cube"
    cfg["grid.num_elements"] = [8, 8]
    cfg["parameter.0.mu"] = [0.1]
    path = str(tmp_path / "test.cfg")
    cfg.write(path)
    back = Configuration.from_file(path)
    assert back["grid.type"] == "cube"
    assert back["grid.num_elements"] == [8, 8]
    assert back.sub("parameter").sub("0")["mu"] == [0.1]
    assert back.has_sub("grid") and not back.has_sub("nope")


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_default_config_text_equals_reference(name, tmp_path):
    """write_config() text equal; each package's written file loads in the
    other to the same tree; chip_smoke's recorded digest is the
    reference's."""
    import chip_smoke

    t_cls, j_cls = getattr(tex, EXAMPLES[name]), getattr(jex, EXAMPLES[name])
    text = j_cls.write_config().to_string()
    assert t_cls.static_id() == j_cls.static_id()
    assert t_cls.write_config().to_string() == text
    assert chip_smoke.CLI_CONFIG_SHA256[name] == hashlib.sha256(text.encode()).hexdigest()
    t_path = t_cls.write_config_file(str(tmp_path / "port.cfg"))
    j_path = j_cls.write_config_file(str(tmp_path / "reference.cfg"))
    assert JConfiguration.from_file(t_path).as_dict() == Configuration.from_file(
        j_path).as_dict() == JConfiguration.from_file(j_path).as_dict()
    assert Configuration.from_file(t_path).to_string() == text


def test_example_write_config_and_initialize(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = tex.LinearellipticExampleSWIPDG.write_config_file()
    assert os.path.isfile(path)
    d = tex.LinearellipticExampleSWIPDG(device="cpu").initialize([path]).discretization()
    assert bool(torch.isfinite(d.solve(options={"type": "direct"})).all())


def test_cli_write_then_solve(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli("swipdg") == 0
    assert "wrote default config" in capsys.readouterr().out
    assert cli("swipdg", "--solver", "direct") == 0
    out = capsys.readouterr().out
    assert "|u|_max" in out and "type=direct" in out


def test_cli_thermalblock_parametric(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli("thermalblock") == 0
    assert cli("thermalblock", "--solver", "direct", "--visualize", "tb") == 0
    out = capsys.readouterr().out
    assert "parameter block 1" in out
    assert os.path.isfile("tb_mu_0.vtu") and os.path.isfile("tb_mu_1.vtu")


def test_block_swipdg_example(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = tex.LinearellipticExampleBlockSWIPDG.write_config_file()
    d = tex.LinearellipticExampleBlockSWIPDG(device="cpu").initialize([path]).discretization()
    assert d.num_subdomains() == 4


def _payloads(dec):
    """The slot values of each matrix (its dense form for any other
    operator) or the entries of each vector, as numpy."""
    def host(p):
        if hasattr(p, "pattern"):
            p = p.values
        elif hasattr(p, "to_dense"):
            p = p.to_dense()
        return np.asarray(p.detach().cpu() if hasattr(p, "detach") else p)

    parts = list(dec.components) + ([dec.affine_part] if dec.affine_part is not None else [])
    return [host(p) for p in parts]


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_facade_discretizations_equal_reference(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    t_cls, j_cls = getattr(tex, EXAMPLES[name]), getattr(jex, EXAMPLES[name])
    path = j_cls.write_config_file()
    t = t_cls(device="cpu").initialize([path])
    j = j_cls().initialize([path])
    assert [{k: list(v) for k, v in mu.items()} for mu in t.parameters()] == [
        {k: list(v) for k, v in mu.items()} for mu in j.parameters()]
    td, jd = t.discretization(), j.discretization()
    assert type(td).__name__ == type(jd).__name__
    assert td.space.num_dofs == jd.space.num_dofs
    pairs = [(td.get_operator(), jd.get_operator()), (td.get_rhs(), jd.get_rhs())]
    pairs += [(td.get_product(p), jd.get_product(p)) for p in td.available_products()]
    assert td.available_products() == jd.available_products()
    for a, b in pairs:
        assert [c.expression for c in a.coefficients] == [c.expression for c in b.coefficients]
        for x, y in zip(_payloads(a), _payloads(b)):
            np.testing.assert_allclose(x, np.asarray(y), rtol=0,
                                       atol=1e-12 * max(np.abs(np.asarray(y)).max(), 1e-300))


def test_cli_rb_and_esv2007_study(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli("rb") == 0
    assert "wrote default config" in capsys.readouterr().out
    assert cli("rb") == 0
    out = capsys.readouterr().out
    assert "final basis size" in out
    assert float(out.rsplit("max error ", 1)[1].split()[0]) <= 1e-6
    assert cli("study", "--case", "esv2007") == 0
    out = capsys.readouterr().out
    eff = [float(v) for v in out.split("eff_ESV2007:")[1].split()]
    np.testing.assert_allclose(eff, [1.3666, 1.2771, 1.2326], atol=1e-2)


def test_fvca7_poster_workflow_matches_recorded_table(capsys):
    """The reference's (slow) poster test: every partitioning within 2e-3 of
    the recorded table, eff at level 0 within 1% of the reference's; the
    CLI prints the same rows."""
    ref_eff = {"[1 1 1]": 3.35, "[2 2 1]": 2.47, "[4 4 1]": 2.03, "[8 8 1]": 1.81}
    results = fvca7_poster_study(device="cpu")
    assert set(results) == set(ref_eff)
    for part, rows in results.items():
        for typ in ("energy", "eta_OS2014", "eff_OS2014"):
            exp = expected_results(f"FVCA7.poster.{part}", "alu_conforming", 1, typ)
            np.testing.assert_allclose(rows[typ], exp, rtol=2e-3, err_msg=f"{part} {typ}")
        assert abs(rows["eff_OS2014"][0] - ref_eff[part]) < 0.01 * 3.4
    assert cli("study", "--case", "os2014") == 0
    out = capsys.readouterr().out
    assert out.count("[8 8 1]") == 2 and f"{results['[8 8 1]']['eff_OS2014'][1]:>8.3f}" in out


def test_interval_swipdg_example_facade(tmp_path):
    """The reference's interval façade case (tests/test_interval_swipdg.py)."""
    cfg = Configuration()
    cfg["grid.type"] = "stuff.grid.provider.interval"
    cfg["grid.lower_left"] = 0.0
    cfg["grid.upper_right"] = 1.0
    cfg["grid.num_elements"] = 16
    cfg["boundary_info.type"] = "stuff.grid.boundaryinfo.alldirichlet"
    cfg["problem.type"] = "hdd.linearelliptic.problem.default"
    cfg_file = tmp_path / "interval_swipdg.cfg"
    cfg_file.write_text(cfg.to_string())
    d = tex.LinearellipticExampleSWIPDG(device="cpu").initialize([str(cfg_file)]).discretization()
    assert d.space.grid.cell_type == "interval"
    assert bool(torch.isfinite(d.solve(None, options={"type": "direct"})).all())


def test_alu_conforming_provider_and_stencil_cg(tmp_path, monkeypatch, capsys):
    """The ALU-conforming provider makes the bisected ESV2007 grid; through
    the CLI's config the SWIPDG solve takes stencil_cg on it."""
    from dune_hdd_tpu_torch.grid.hierarchy import GridProviders
    from dune_hdd_tpu_torch.grid.structured import alu_cube_grid
    from dune_hdd_tpu_torch.grid.structured_order import structured_cell_order

    g = GridProviders.create("stuff.grid.provider.alu_conforming",
                             {"lower_left": [-1, -1], "upper_right": [1, 1],
                              "num_elements": [4, 4], "num_refinements": 4})
    ref = alu_cube_grid((-1.0, -1.0), (1.0, 1.0), (4, 4), refinements=4)
    np.testing.assert_array_equal(g.vertices, ref.vertices)
    np.testing.assert_array_equal(g.cells, ref.cells)
    assert structured_cell_order(g) is not None
    monkeypatch.chdir(tmp_path)
    cfg = tex.LinearellipticExampleSWIPDG.write_config()
    for key, value in {"grid.type": "stuff.grid.provider.alu_conforming",
                       "grid.num_elements": [4, 4], "grid.num_refinements": 4}.items():
        cfg[key] = value
    cfg.write("alu.cfg")
    assert cli("swipdg", "alu.cfg", "--solver", "stencil_cg") == 0
    out = capsys.readouterr().out
    assert "type=stencil_cg" in out and f": {3 * 32 * 16} DoF" in out


def test_default_device_raises_without_a_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["swipdg"])
    assert not os.listdir(tmp_path)


def test_module_entry_point_help():
    proc = subprocess.run([sys.executable, "-m", "dune_hdd_tpu_torch.cli.main", "--help"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "--device" in proc.stdout
