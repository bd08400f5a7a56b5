"""CDR_3d test case (port of roms_tpu/cases/cdr_3d.py; reference:
tests/CDR_3d/): mCDR forcing from full-3D ALK/DIC tracer-flux fields
(reference: src/cdr_frc.F:111-114, cdr_frc.opt forcing_3d).  Physics and
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
    return cdr_real.build(workdir, "3d", ntimes=ntimes, dtype=dtype,
                          device=device)
