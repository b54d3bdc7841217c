"""A run with the timed path broken underneath reads ``correct`` false: a
solve that returns its state unchanged (u = 0), half of the answer left
out, the SpMV's output altered where the kernel produces it, and the same
in the float64 application alone (the refinement's)."""
import pytest
import torch

from hddbench import run as harness
from hddbench.tests.conftest import SMALL


def _broken(entry_system, fault):
    class Broken(entry_system):
        def _outcome(self, *args):
            out = super()._outcome(*args)
            u = out.u
            if fault == "unchanged":
                u = torch.zeros_like(u)
            elif fault == "half":
                u = u.clone()
                u[: u.numel() // 2] = 0.0
            return out._replace(u=u)

    return Broken


def _entry(cell):
    from hddbench.entries import spe10_bench, thermalblock_snapshots

    return spe10_bench.System if cell.startswith("spe10") else thermalblock_snapshots.System


@pytest.mark.parametrize("fault", ["unchanged", "half"])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_broken_answer_is_not_correct(cell, fault, cpu):
    result = harness.run_cell(cell, 2 ** 31 + 3, 0.5, False, cpu, overrides=SMALL[cell],
                              system_factory=_broken(_entry(cell), fault))
    assert result["correct"] is False


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_altered_spmv_is_not_correct(cell, cpu, monkeypatch):
    from dune_hdd_tpu_torch.la.stencil import StencilBlockEll

    matvec = StencilBlockEll.matvec

    def altered(self, X):
        Y = matvec(self, X).clone()
        Y[:, :, 0] *= 1.01  # one lattice row, as the kernel writes it
        return Y

    monkeypatch.setattr(StencilBlockEll, "matvec", altered)
    result = harness.run_cell(cell, 2 ** 31 + 5, 0.5, False, cpu, overrides=SMALL[cell])
    assert result["correct"] is False
    assert result["check"]["op_rel"]["value"] > result["check"]["op_rel"]["limit"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_altered_float64_spmv_is_not_correct(cell, cpu, monkeypatch):
    """Only the float64 application altered: b8's float32 PCG stays sound,
    and its refinement converges to the altered system, in which
    ``res_own`` reads it as solved; ``op_rel64`` has to catch it."""
    from dune_hdd_tpu_torch.la.stencil import StencilBlockEll

    matvec = StencilBlockEll.matvec

    def altered(self, X):
        Y = matvec(self, X)
        if X.dtype == torch.float64:
            Y = Y.clone()
            Y[:, :, 0] *= 1.01
        return Y

    monkeypatch.setattr(StencilBlockEll, "matvec", altered)
    result = harness.run_cell(cell, 2 ** 31 + 7, 0.5, False, cpu, overrides=SMALL[cell])
    assert result["correct"] is False
    check = result["check"]
    name = "op_rel64" if "op_rel64" in check else "op_rel"
    assert check[name]["value"] > check[name]["limit"]
    if name == "op_rel64":
        assert check["op_rel"]["value"] <= check["op_rel"]["limit"]
