"""The controls at a small size: the program's readings within the cell's
limits, each control's reading apart from the program's.  On the card at
the cells' sizes the same functions run as ``hddbench/control.py``."""
import pytest

from hddbench.control import seed_readings, setup, summary
from hddbench.tests.conftest import SMALL

# how far each compared number's control reads above the program: the
# residual in the solved system and the precision controls of the operator
# and rhs by orders of magnitude; the thermalblock's float32 solve by as
# much in the reference's system
SEPARATION = {"res_ref": 1e3, "res_own": 100.0, "op_rel": 1e3, "op_rel64": 1e3,
              "rhs_rel": 1e3}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_controls_separate(cell, cpu):
    spec, config, system, reference = setup(cell, cpu, SMALL[cell])
    rows = [seed_readings(spec, config, system, reference, 2 ** 31 + 11 + k, cpu,
                          control=(k == 0)) for k in range(2)]
    s = summary(rows)
    limits = spec["workload"]["limits"]
    for key, limit in limits.items():
        low, up = s["lower"][key], s["upper"][key]
        assert low <= limit < up and up >= SEPARATION[key] * low, (key, low, limit, up)
