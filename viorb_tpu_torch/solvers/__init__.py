"""Geometric solvers: triangulation and two-view initialization."""

from viorb_tpu_torch.solvers.triangulation import (  # noqa: F401
    parallax_cos,
    projection_matrix,
    triangulate_two_view,
)
from viorb_tpu_torch.solvers.two_view import TwoViewResult, two_view_init  # noqa: F401
