from .ns_2d import Force, random_force, solve_navier_stokes_2d
from .random_fields import gaussian_random_field, grf_sqrt_eigenvalues

__all__ = ["Force", "random_force", "solve_navier_stokes_2d", "gaussian_random_field",
           "grf_sqrt_eigenvalues"]
