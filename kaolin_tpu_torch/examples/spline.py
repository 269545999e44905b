"""Differentiable cubic Hermite spline interpolation.

Reference: ``examples/tutorial/ian_torch_cubic_spline_interp.py:24`` (fork
layer) — the building block of the fork's parametric spline meshes.
"""

import torch

__all__ = ['h_poly', 'interp_func_with_tangent', 'natural_cubic_spline']


def h_poly(t):
    """Hermite basis polynomials evaluated at t (any shape)."""
    t2 = t * t
    t3 = t2 * t
    return (1. - 3. * t2 + 2. * t3, t - 2. * t2 + t3, 3. * t2 - 2. * t3,
            t3 - t2)


def interp_func_with_tangent(x, y, m, xs):
    """Evaluates the cubic Hermite interpolant through knots (x, y) with
    tangents m at query points xs (differentiable w.r.t. y and m).

    Reference: ``ian_torch_cubic_spline_interp.py:24``.
    """
    if y.shape[0] == 1:
        return y[0] + torch.zeros_like(xs)
    # torch.searchsorted(right=False) is jnp.searchsorted's default side
    idx = torch.clamp(torch.searchsorted(x[1:].contiguous(),
                                         xs.contiguous()),
                      0, x.shape[0] - 2)
    dx = x[idx + 1] - x[idx]
    h0, h1, h2, h3 = h_poly((xs - x[idx]) / dx)
    return (h0 * y[idx] + h1 * m[idx] * dx + h2 * y[idx + 1]
            + h3 * m[idx + 1] * dx)


def natural_cubic_spline(x, y, xs):
    """Cubic interpolation with finite-difference tangents (the fork's
    default usage pattern)."""
    m = torch.cat([
        (y[1:2] - y[0:1]) / (x[1:2] - x[0:1]),
        (y[2:] - y[:-2]) / (x[2:] - x[:-2]),
        (y[-1:] - y[-2:-1]) / (x[-1:] - x[-2:-1]),
    ])
    return interp_func_with_tangent(x, y, m, xs)
