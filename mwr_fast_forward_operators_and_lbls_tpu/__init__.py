"""mwr_fast_forward_operators_and_lbls_tpu — ground-based microwave
radiative-transfer framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
pipeline `apschera2023uzk/MWR_fast_forward_operators_and_LBLs`: Rosenkranz
line-by-line absorption (R98/R17/R20/R24), refraction-bent slant-path
geometry, non-scattering downwelling RTE to HATPRO brightness temperatures,
autodiff K-matrix Jacobians, an RTTOV-gb-style fast predictor-regression
operator distilled on the accelerator, plus the surrounding campaign data pipeline
(ingest -> forward -> statistics/evaluation), all sharded over device meshes.
"""

__version__ = "0.1.0"

from .models.lbl import LBLConfig, forward_batch, forward_single  # noqa: F401
