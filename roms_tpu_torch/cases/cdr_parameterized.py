"""CDR_parameterized test case (port of
roms_tpu/cases/cdr_parameterized.py; reference: tests/CDR_parameterized/):
Gaussian-footprint mCDR releases from lon/lat/depth/scale parameters
(reference: src/cdr_frc.F:264-292, cdr_frc.opt forcing_parameterized).
Physics and configuration are shared with the other CDR cases — see
`cases/cdr_real.py`."""

from __future__ import annotations

import torch

from roms_tpu_torch.cases import cdr_real
from roms_tpu_torch.cases.cdr_real import (TRACER_NAMES,  # noqa: F401
                                           base_config)
from roms_tpu_torch.experiment import Experiment


def build(workdir: str, ntimes: int = 10,
          dtype: torch.dtype = torch.float64,
          device: torch.device | str = "cuda") -> Experiment:
    return cdr_real.build(workdir, "parameterized", ntimes=ntimes, dtype=dtype,
                          device=device)
