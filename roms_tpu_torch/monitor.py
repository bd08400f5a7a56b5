"""Blowup detection on the reduced diagnostics (the port's own copy of
roms_tpu/monitor.py:check_blowup; reference: src/diag.F:624-634)."""

from __future__ import annotations

import numpy as np


class BlowupError(RuntimeError):
    pass


def check_blowup(diag_row, step: int):
    """NaN/Inf watchdog on the reduced diagnostics: the functional
    replacement of the reference's inspection of the printed KE line
    (reference: diag.F:624-634 "Abnormal termination: BLOWUP")."""
    vals = np.asarray(diag_row, np.float64)
    if not np.isfinite(vals).all():
        raise BlowupError(f"Abnormal termination: BLOWUP at step {step}: "
                          f"diagnostics {vals}")
