"""Gas + hydrometeor absorption coefficients (the LBL hot path)."""

import jax
import jax.numpy as jnp

from ...constants.h2o_lines import H2O_MODELS
from ...constants.o2_lines import O2_MODELS
from .h2o import h2o_absorption  # noqa: F401
from .liquid import liquid_absorption  # noqa: F401
from .n2 import n2_absorption  # noqa: F401
from .o2 import o2_absorption  # noqa: F401
from .o3 import o3_absorption  # noqa: F401

# All nine Rosenkranz releases the reference sweeps (R98..R24 incl. the
# speed-dependent R19SD/R20SD variants, old_merge2nc.py:417-435).
ABSORPTION_MODELS = tuple(H2O_MODELS)


@jax.named_scope("absorption")    # names its fusions in traces and HLO
def total_absorption(f_ghz, p_hpa, t_k, rho_gm3, lwc_gm3=None, model: str = "R24",
                     o3_ppmv=None):
    """Total atmospheric absorption [Np/km] for one named model family.

    Sum of H2O lines+continuum, O2 lines+nonresonant, dry collision-induced
    continuum, and (optionally) cloud liquid and ozone — the full
    clear/cloudy-sky absorption PyRTlib evaluates per (frequency, layer) in
    the reference's hot loop (/root/reference/python_src/proc/
    PyRTlib_processing.py:99-151); O3 covers the ARMS-gb capability
    (ARMS_gb_processing.py:94-99).
    """
    if model not in H2O_MODELS:
        raise ValueError(f"unknown absorption model {model!r}; have {ABSORPTION_MODELS}")
    e = jnp.asarray(rho_gm3) * jnp.asarray(t_k) / 217.0
    pda = jnp.asarray(p_hpa) - e
    alpha = (
        h2o_absorption(f_ghz, p_hpa, t_k, rho_gm3, H2O_MODELS[model])
        + o2_absorption(f_ghz, p_hpa, t_k, rho_gm3, O2_MODELS[model])
        + n2_absorption(f_ghz, pda, t_k, variant=model)
    )
    if lwc_gm3 is not None:
        alpha = alpha + liquid_absorption(f_ghz, t_k, lwc_gm3)
    if o3_ppmv is not None:
        alpha = alpha + o3_absorption(f_ghz, p_hpa, t_k, o3_ppmv)
    return alpha
