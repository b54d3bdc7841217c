"""Example façades: write_config_file / initialize / discretization.

Counterpart of ``dune_hdd_tpu/cli/examples.py`` (the reference's example
classes, examples/linearelliptic/cg.hh:27-92, swipdg.hh, block-swipdg.hh,
thermalblock.hh, and its DiscreteProblem driver, discreteproblem.hh:44-398):
a config-driven bootstrap (grid provider, boundary info, problem factory,
discretization) and a ``write_config()`` that emits the complete default
config, text-equal to the reference package's.  Every façade builds its
discretization on ``device``: the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..device import resolve_device
from ..discretizations import CGDiscretization, SWIPDGDiscretization
from ..discretizations.block_swipdg import BlockSWIPDGDiscretization
from ..grid.hierarchy import GridProviders
from ..problems.provider import ProblemsProvider
from ..utils.config import Configuration

__all__ = [
    "LinearellipticExampleCG",
    "LinearellipticExampleTensorCG",
    "LinearellipticExampleSWIPDG",
    "LinearellipticExampleBlockSWIPDG",
    "ThermalblockExample",
]


class _ExampleBase:
    discretization_class = None
    default_problem = "hdd.linearelliptic.problem.ESV2007"

    @classmethod
    def static_id(cls) -> str:
        raise NotImplementedError

    @classmethod
    def write_config(cls) -> Configuration:
        cfg = Configuration()
        cfg["grid.type"] = "stuff.grid.provider.cube"
        cfg["grid.lower_left"] = [-1, -1]
        cfg["grid.upper_right"] = [1, 1]
        cfg["grid.num_elements"] = [8, 8]
        cfg["grid.num_refinements"] = 0
        cfg["grid.cell_type"] = "triangle"
        cfg["boundary_info.type"] = "stuff.grid.boundaryinfo.alldirichlet"
        cfg["problem.type"] = cls.default_problem
        cfg["logging.info"] = True
        cfg["logging.debug"] = False
        cfg["logging.file"] = False
        cfg["parameter.0.diffusion_factor"] = [0.1]
        cfg["parameter.1.diffusion_factor"] = [1.0]
        return cfg

    @classmethod
    def write_config_file(cls, filename: Optional[str] = None) -> str:
        """Write the annotated default config, enumerating the registered
        grid / boundary / problem providers like DiscreteProblem::write_config
        (discreteproblem.hh:63-83)."""
        filename = filename or (cls.static_id() + ".cfg")
        header = (
            f"# default configuration for {cls.static_id()}\n"
            f"# available grid types: {', '.join(GridProviders.available())}\n"
            "# available boundary info types: alldirichlet, allneumann, normalbased, idbased\n"
            "# available problem types:\n"
            + "".join(f"#   {t}\n" for t in ProblemsProvider.available())
        )
        with open(filename, "w") as fh:
            fh.write(header + "\n" + cls.write_config().to_string())
        return filename

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._discretization = None
        self.config: Optional[Configuration] = None

    def initialize(self, args: Optional[List[str]] = None) -> "_ExampleBase":
        """args: [config_file] (argv-style, like initialize(argc, argv))."""
        args = list(args or [])
        cfg_file = None
        for a in args:
            if a.endswith(".cfg") or os.path.isfile(a):
                cfg_file = a
        if cfg_file is None:
            cfg_file = self.static_id() + ".cfg"
        if os.path.isfile(cfg_file):
            cfg = Configuration.from_file(cfg_file)
        else:
            cfg = self.write_config()
        self.config = cfg
        grid_cfg = dict(cfg.sub("grid").as_dict()) if cfg.has_sub("grid") else {}
        grid_type = grid_cfg.pop("type", "stuff.grid.provider.cube")
        grid = GridProviders.create(grid_type, grid_cfg)
        bi_cfg = cfg.sub("boundary_info").as_dict() if cfg.has_sub("boundary_info") else {}
        problem_cfg = dict(cfg.sub("problem").as_dict()) if cfg.has_sub("problem") else {}
        problem_type = problem_cfg.pop("type", self.default_problem)
        if getattr(grid, "cell_type", None) == "interval":
            # 1D grids need a 1x1 diffusion tensor (SGrid<1,1> instantiation)
            dt = dict(problem_cfg.get("diffusion_tensor", {}) or {})
            dt.setdefault("dim", 1)
            problem_cfg["diffusion_tensor"] = dt
        problem = ProblemsProvider.create(problem_type, problem_cfg)
        self._discretization = self._make_discretization(grid, bi_cfg, problem, cfg)
        return self

    def _make_discretization(self, grid, bi_cfg, problem, cfg):
        return self.discretization_class(grid, bi_cfg, problem, device=self.device)

    def discretization(self):
        if self._discretization is None:
            raise RuntimeError("call initialize() first")
        return self._discretization

    def parameters(self) -> List[dict]:
        """The [parameter] blocks 0.*, 1.*, ... (cg_main.cc:45-61)."""
        cfg = self.config
        out = []
        if cfg is None or not cfg.has_sub("parameter"):
            return out
        sub = cfg.sub("parameter")
        i = 0
        while sub.has_sub(str(i)) or sub.has_key(str(i)):
            block = sub.sub(str(i)).as_dict() if sub.has_sub(str(i)) else {}
            out.append({k: np.atleast_1d(np.asarray(v, dtype=float)) for k, v in block.items()})
            i += 1
        return out


class LinearellipticExampleCG(_ExampleBase):
    discretization_class = CGDiscretization

    @classmethod
    def static_id(cls) -> str:
        return "example.linearelliptic.cg"


class LinearellipticExampleTensorCG(_ExampleBase):
    """CG on tensor-product grids in d = 1, 2, 3: the SGrid<1,1> / <3,3>
    instantiations of the reference example (cg.cc:19-21)."""

    @classmethod
    def static_id(cls) -> str:
        return "example.linearelliptic.cg.tensor"

    def initialize_tensor(self, dim: int = 3, num_elements=4, lower=0.0, upper=1.0,
                          problem=None, boundary_info=None) -> "LinearellipticExampleTensorCG":
        """Programmatic initialization (the config path stays 2D; the
        reference selects the grid dimension at compile time, here it is a
        run-time argument)."""
        from ..discretizations.tensor_cg import TensorCGDiscretization
        from ..grid.tensor import tensor_grid

        num_elements = ([int(num_elements)] * dim
                        if np.isscalar(num_elements) else list(num_elements))
        grid = tensor_grid([float(lower)] * dim, [float(upper)] * dim, num_elements)
        self._discretization = TensorCGDiscretization(grid, boundary_info, problem,
                                                      device=self.device)
        return self


class LinearellipticExampleSWIPDG(_ExampleBase):
    discretization_class = SWIPDGDiscretization

    @classmethod
    def static_id(cls) -> str:
        return "example.linearelliptic.swipdg"


class LinearellipticExampleBlockSWIPDG(_ExampleBase):
    discretization_class = BlockSWIPDGDiscretization

    @classmethod
    def static_id(cls) -> str:
        return "example.linearelliptic.block-swipdg"

    @classmethod
    def write_config(cls) -> Configuration:
        cfg = super().write_config()
        cfg["grid.num_partitions"] = [2, 2]
        cfg["grid.oversampling_layers"] = 0
        return cfg

    def _make_discretization(self, grid, bi_cfg, problem, cfg):
        parts = cfg.get("grid.num_partitions", [2, 2])
        layers = int(cfg.get("grid.oversampling_layers", 0))
        return BlockSWIPDGDiscretization(grid, bi_cfg, problem, num_partitions=parts,
                                         oversampling_layers=layers, device=self.device)


class ThermalblockExample(LinearellipticExampleBlockSWIPDG):
    default_problem = "hdd.linearelliptic.problem.thermalblock"

    @classmethod
    def static_id(cls) -> str:
        return "example.linearelliptic.thermalblock"

    @classmethod
    def write_config(cls) -> Configuration:
        cfg = super().write_config()
        cfg["grid.lower_left"] = [0, 0]
        cfg["grid.upper_right"] = [1, 1]
        cfg["problem.diffusion_factor.num_elements"] = [2, 2]
        cfg["parameter.0.diffusion_factor"] = [0.1, 0.2, 0.5, 1.0]
        cfg["parameter.1.diffusion_factor"] = [1.0, 1.0, 1.0, 1.0]
        # [pymor] greedy settings of the RB workflow
        # (problems/thermalblock.hh:256-286)
        cfg["pymor.training_set"] = "random"
        cfg["pymor.num_training_samples"] = 10
        cfg["pymor.max_rb_size"] = 20
        cfg["pymor.target_error"] = 1e-6
        cfg["pymor.extension_algorithm"] = "gram_schmidt"
        cfg["pymor.extension_algorithm_product"] = "h1_semi"
        cfg["pymor.greedy_error_norm"] = "h1_semi"
        return cfg

    def initialize_tensor(self, dim: int = 3, num_elements=8, num_blocks=(2, 2, 2),
                          boundary_info=None) -> "ThermalblockExample":
        """The ThermalblockExample<SGrid<3,3>> instantiation
        (examples/linearelliptic/thermalblock.hh:91): a d-dimensional
        parametric thermalblock on a tensor grid through the Q1 tensor CG
        discretization (the block-SWIPDG layer stays 2D)."""
        from ..discretizations.tensor_cg import TensorCGDiscretization
        from ..grid.tensor import tensor_grid
        from ..problems.thermalblock import ThermalblockProblem

        num_elements = ([int(num_elements)] * dim
                        if np.isscalar(num_elements) else list(num_elements))
        problem = ThermalblockProblem(num_blocks=tuple(num_blocks)[:dim])
        grid = tensor_grid([0.0] * dim, [1.0] * dim, num_elements)
        self._discretization = TensorCGDiscretization(grid, boundary_info, problem,
                                                      device=self.device)
        return self
