"""Model zoo (the worlds the port steps so far)."""

from nimblephysics_tpu_torch.models.builtin import (
    box_stack,
    catapult,
    half_cheetah,
    inverted_double_pendulum,
    jump_worm,
)
