"""Model zoo (the worlds the port steps so far)."""

from nimblephysics_tpu_torch.models.builtin import (
    box_drop,
    box_stack,
    cartpole,
    catapult,
    half_cheetah,
    inverted_double_pendulum,
    jump_worm,
)
from nimblephysics_tpu_torch.models.human import human_standing, rajagopal_humanoid
