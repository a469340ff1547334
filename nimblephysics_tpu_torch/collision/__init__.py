"""Static collision slot plan."""

from nimblephysics_tpu_torch.collision.collider import Collider
