"""The port's ``Lattice`` conversions against the JAX package's, on a few values.

``utils/units.py`` is host float64 arithmetic in both packages; each
conversion must give the JAX result exactly on sim_2's res-2 lattice
(phys_dl 0.25 / 62, phys_dt from the lattice viscosity 0.001).
"""

import numpy as np
import pytest

from tnl_lbm_tpu.utils import Lattice as JLattice
from tnl_lbm_tpu_torch.utils.units import Lattice

DL = 0.25 / 62
ARGS = dict(global_size=(32, 64, 64), phys_origin=(0.1, -0.2, 0.3), phys_dl=DL,
            phys_dt=0.001 / 1.5e-5 * DL * DL, phys_viscosity=1.5e-5)
VALUES = (0.0, 1e-6, 0.0123456789, 3.5, 17.0)

CONVERSIONS = {
    "phys2lbm_viscosity": lambda u, v: u.phys2lbm_viscosity(v),
    "lbm2phys_viscosity": lambda u, v: u.lbm2phys_viscosity(v),
    "phys2lbm_point": lambda u, v: u.phys2lbm_point((v, 2 * v, -v)),
    "lbm2phys_x": lambda u, v: [u.lbm2phys_x(v, axis) for axis in range(3)],
    "lbm2phys_force": lambda u, v: u.lbm2phys_force(v),
    "phys2lbm_time": lambda u, v: u.phys2lbm_time(v),
    "lbm2phys_time": lambda u, v: u.lbm2phys_time(v),
}


@pytest.mark.parametrize("name", list(CONVERSIONS))
def test_lattice_conversion_matches_jax(name):
    port, ref = Lattice(**ARGS), JLattice(**ARGS)
    for v in VALUES:
        got, want = (np.asarray(CONVERSIONS[name](u, v), np.float64) for u in (port, ref))
        np.testing.assert_array_equal(got, want, err_msg=f"{name}({v})")
    assert port.lbm_viscosity() == ref.lbm_viscosity()


def test_conversions_invert_each_other():
    u = Lattice(**ARGS)
    for v in VALUES:
        assert np.isclose(u.lbm2phys_viscosity(u.phys2lbm_viscosity(v)), v, rtol=1e-14, atol=0)
        assert np.isclose(u.lbm2phys_force(u.phys2lbm_force(v)), v, rtol=1e-14, atol=0)
        assert np.isclose(u.lbm2phys_time(u.phys2lbm_time(v)), v, rtol=1e-14, atol=0)
        assert np.allclose(u.phys2lbm_point(u.lbm2phys_point((v, v, v))), v, rtol=1e-14,
                           atol=1e-12)
        assert np.isclose(u.phys2lbm_x(u.lbm2phys_x(v, 1), 1), v, rtol=1e-14, atol=1e-12)
