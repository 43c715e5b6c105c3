"""Evaluation layer: statistics, sky classification, deviations, plots.

`plots` and `report` import matplotlib, so they are imported where the
figure stage needs them and not here: the forward path runs without it.
"""

from . import deviations, sky, stats  # noqa: F401
