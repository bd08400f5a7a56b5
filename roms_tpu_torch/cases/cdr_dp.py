"""CDR_dp test case (port of roms_tpu/cases/cdr_dp.py; reference:
tests/CDR_dp/): mCDR forcing from layerwise ALK/DIC depth profiles,
conservatively remapped onto the model levels (reference:
src/cdr_frc.F:189-243, cdr_frc.opt forcing_depth_profiles).  Physics and
configuration are shared with the other CDR cases — see
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
    return cdr_real.build(workdir, "dp", ntimes=ntimes, dtype=dtype,
                          device=device)
