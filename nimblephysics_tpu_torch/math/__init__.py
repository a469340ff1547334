"""Math layer: Lie-group geometry (lie.py), spatial inertia (spatial.py),
the finite-difference oracle (finite_difference.py) and the 1-D function
specs of the spline-driven joints (splines.py)."""

from nimblephysics_tpu_torch.math import splines
from nimblephysics_tpu_torch.math.finite_difference import (
    finite_difference_jacobian,
    ridders_derivative,
)
from nimblephysics_tpu_torch.math.lie import (
    Ad,
    Ad_inv,
    ad,
    ad_apply,
    dAd,
    dad_apply,
    euler_to_matrix,
    exp_map,
    exp_map_rot,
    log_map,
    log_map_rot,
    matrix_to_euler_xyz,
    matrix_to_euler_zyx,
    rp_to_transform,
    skew,
    so3_left_jacobian,
    so3_left_jacobian_inv,
    so3_left_jacobian_time_deriv,
    so3_right_jacobian,
    so3_right_jacobian_inv,
    so3_right_jacobian_time_deriv,
    so3_right_jacobian_time_deriv_deriv,
    transform_inv,
    transform_point,
    transform_vector,
    unskew,
)
from nimblephysics_tpu_torch.math.spatial import (
    inertia_box,
    inertia_capsule,
    inertia_cylinder,
    inertia_ellipsoid,
    inertia_sphere,
    spatial_inertia_matrix,
)
