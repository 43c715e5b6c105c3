"""Cloud liquid-water absorption (Rayleigh regime).

Liebe-Hufford-Manabe (1991) double-Debye dielectric model, the `abliq`
formulation used by the Rosenkranz codes that PyRTlib wraps.  Valid for cloud
droplets much smaller than the wavelength (no scattering) — the same
assumption the whole reference pipeline makes (non-scattering RTE).

Implemented with explicit real/imaginary arithmetic (no complex dtype) so the
same expression also fits a hand-written kernel unchanged.
"""

import jax.numpy as jnp


def liquid_absorption(f_ghz, t_k, lwc_gm3):
    """Cloud liquid absorption [Np/km].

    Args:
      f_ghz:   frequency [GHz].
      t_k:     temperature [K].
      lwc_gm3: liquid water content [g/m^3].
    """
    f = jnp.asarray(f_ghz)
    t = jnp.asarray(t_k)
    w = jnp.asarray(lwc_gm3)

    theta1 = 1.0 - 300.0 / t
    eps0 = 77.66 - 103.3 * theta1
    eps1 = 0.0671 * eps0
    eps2 = 3.52
    fp = 20.1 * jnp.exp(7.88 * theta1)  # primary relaxation frequency [GHz]
    fs = 39.8 * fp                      # secondary relaxation frequency [GHz]

    u = f / fp
    v = f / fs
    # eps = eps2 + (eps0-eps1)/(1+iu) + (eps1-eps2)/(1+iv)
    re = eps2 + (eps0 - eps1) / (1.0 + u * u) + (eps1 - eps2) / (1.0 + v * v)
    im = -(eps0 - eps1) * u / (1.0 + u * u) - (eps1 - eps2) * v / (1.0 + v * v)

    # Im[(eps-1)/(eps+2)] = 3*im / ((re+2)^2 + im^2)
    aimag = 3.0 * im / ((re + 2.0) ** 2 + im * im)
    return -0.06286 * aimag * f * w
