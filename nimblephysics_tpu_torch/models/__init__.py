"""Model zoo (the worlds the port steps so far)."""

from nimblephysics_tpu_torch.models.builtin import half_cheetah
