"""Simulation layer (reference: dart/simulation, SURVEY.md 2.1).

World container, state/action API, smooth-dynamics helpers, recordings
and checkpoints, and the batched RL environment.
"""

from nimblephysics_tpu_torch.simulation.world import (
    SolverConfig,
    World,
    merge_state,
    split_state,
    world_fk,
    world_forward_dynamics,
    world_full_kinematics,
    world_integrate_positions,
    world_mass_matrix,
)
from nimblephysics_tpu_torch.simulation.recording import (
    Recording,
    load_checkpoint,
    save_checkpoint,
)
from nimblephysics_tpu_torch.simulation.env import BatchedEnv, EnvState, StepOutput
