"""World spec and solver configuration."""

from nimblephysics_tpu_torch.simulation.world import SolverConfig, World
