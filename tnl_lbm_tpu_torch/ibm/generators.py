"""Lagrangian point-cloud generators for IBM obstacles (counterpart of
``tnl_lbm_tpu/ibm/generators.py``, numpy, the same points).

Analogs of the reference generators (reference: obstacles_ibm.h:5-177 -
ibmSetupRectangle / ibmSetupCylinder / ibmDrawSphere): equidistributed point
clouds with spacing ~sigma, plus min/max spacing diagnostics (provided by
IBM.min_max_spacing).
"""

from __future__ import annotations

import numpy as np


def points_rectangle(center, width, height, sigma) -> np.ndarray:
    """Planar rectangle normal to x: grid of points spaced ~sigma
    (reference obstacles_ibm.h ibmSetupRectangle)."""
    n1 = max(int(round(width / sigma)), 1)
    n2 = max(int(round(height / sigma)), 1)
    ys = np.linspace(-width / 2, width / 2, n1 + 1)
    zs = np.linspace(-height / 2, height / 2, n2 + 1)
    yy, zz = np.meshgrid(ys, zs, indexing="ij")
    pts = np.stack([np.zeros_like(yy), yy, zz], axis=-1).reshape(-1, 3)
    return pts + np.asarray(center)


def points_cylinder(center, diameter, length, sigma, axis: int = 1) -> np.ndarray:
    """Lateral surface of a cylinder along ``axis``
    (reference obstacles_ibm.h ibmSetupCylinder - axis y, spanning the
    domain width)."""
    radius = diameter / 2
    n_circ = max(int(round(np.pi * diameter / sigma)), 3)
    n_ax = max(int(round(length / sigma)), 1)
    thetas = np.linspace(0, 2 * np.pi, n_circ, endpoint=False)
    axials = np.linspace(-length / 2, length / 2, n_ax + 1)
    pts = []
    for a in axials:
        for t in thetas:
            local = [radius * np.cos(t), a, radius * np.sin(t)]
            # rotate so the cylinder axis lies along `axis`
            if axis == 0:
                p = [local[1], local[0], local[2]]
            elif axis == 1:
                p = local
            else:
                p = [local[0], local[2], local[1]]
            pts.append(p)
    return np.asarray(pts) + np.asarray(center)


def points_sphere(center, radius, sigma) -> np.ndarray:
    """Near-equidistributed sphere surface via the Fibonacci spiral
    (reference obstacles_ibm.h ibmDrawSphere)."""
    n = max(int(round(4 * np.pi * radius**2 / sigma**2)), 8)
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    golden = np.pi * (1 + 5**0.5)
    theta = golden * i
    pts = radius * np.stack([
        np.cos(theta) * np.sin(phi),
        np.sin(theta) * np.sin(phi),
        np.cos(phi),
    ], axis=-1)
    return pts + np.asarray(center)
