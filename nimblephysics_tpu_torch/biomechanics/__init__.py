"""Biomechanics: the marker-fitting path (reference: dart/biomechanics).

Counterpart of nimblephysics_tpu/biomechanics: body-scaled forward
kinematics and marker positions, scale groups, anthropometric priors,
marker trace cleaning, the closed-form IK initializer and the bilevel
MarkerFitter. The rest of the JAX package's toolkit (OpenSim parsing, the
.b3d readers and writers, C3D, the dynamics fitter, reports) is not
ported yet.
"""

from nimblephysics_tpu_torch.biomechanics.anthropometrics import (
    Anthropometrics,
    MultivariateGaussian,
)
from nimblephysics_tpu_torch.biomechanics.ik_initializer import IKInitializer
from nimblephysics_tpu_torch.biomechanics.marker_fitter import (
    MarkerFitResult,
    MarkerFitter,
)
from nimblephysics_tpu_torch.biomechanics.marker_fixer import clean_marker_traces
from nimblephysics_tpu_torch.biomechanics.scale_groups import ScaleGroups
from nimblephysics_tpu_torch.biomechanics.scaled_fk import (
    marker_jacobians,
    marker_table,
    marker_world_positions,
    marker_world_positions_frames,
    scaled_forward_kinematics,
    scaled_forward_kinematics_frames,
)
