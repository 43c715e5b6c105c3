"""Tier-1 physics ops: thermo, absorption, geometry, RTE."""

from . import absorption, geometry, rte, thermo  # noqa: F401
