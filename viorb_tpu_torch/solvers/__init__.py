"""Geometric solvers: triangulation, two-view initialization and the Sim3
RANSAC."""

from viorb_tpu_torch.solvers.triangulation import (  # noqa: F401
    parallax_cos,
    projection_matrix,
    triangulate_two_view,
)
from viorb_tpu_torch.solvers.two_view import TwoViewResult, two_view_init  # noqa: F401
from viorb_tpu_torch.solvers.sim3_solver import Sim3Result, horn_sim3, sim3_from_samples, sim3_ransac  # noqa: F401
