"""Relaxation: host reference smoothers + device smoother kernels."""

from . import relaxation, device, smoothing, chebyshev
from .relaxation import (gauss_seidel, jacobi, sor, polynomial, block_jacobi,
                         block_gauss_seidel, gauss_seidel_indexed, jacobi_ne,
                         gauss_seidel_ne, gauss_seidel_nr, schwarz,
                         make_system)
from .smoothing import change_smoothers
from .chebyshev import (chebyshev_polynomial_coefficients,
                        mls_polynomial_coefficients)

__all__ = [
    "relaxation", "device", "smoothing", "chebyshev",
    "gauss_seidel", "jacobi", "sor", "polynomial", "block_jacobi",
    "block_gauss_seidel", "gauss_seidel_indexed", "jacobi_ne",
    "gauss_seidel_ne", "gauss_seidel_nr", "schwarz", "make_system",
    "change_smoothers", "chebyshev_polynomial_coefficients",
    "mls_polynomial_coefficients",
]
