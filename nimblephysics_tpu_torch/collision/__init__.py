"""Collision: the static slot plan, the narrowphase, raycasts and signed
distances."""

from nimblephysics_tpu_torch.collision.collider import Collider, Contacts
from nimblephysics_tpu_torch.collision import narrowphase
from nimblephysics_tpu_torch.collision.raycast import RayHit, raycast
from nimblephysics_tpu_torch.collision.distance import DistanceResult, distance, pairwise_distances
