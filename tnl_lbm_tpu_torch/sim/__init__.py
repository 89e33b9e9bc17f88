"""Simulation layer: configs, domains, the plain step, and the time loop."""

from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig, initial_dfs
from tnl_lbm_tpu_torch.sim.step import make_step

__all__ = ["LBMConfig", "Domain", "initial_dfs", "make_step"]
