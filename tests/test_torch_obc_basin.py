"""Three steps of the port's open-boundary basin (the quick check of the
boundary-condition menu inside a whole step, without KPP) against
roms_tpu.stepper.step, in float64 on the CPU: the radiating case (four
Flather/Orlanski/Orlanski edges, zero data) and the inflow case
(west/east open, specified tracer data).  Setup fields at 1e-13, every
state field after three steps at atol 5e-11 * max(1, max|ref|), the bound
of tests/test_torch_production.py.
"""

import pytest
import torch

from roms_tpu.cases import obc_basin as jbasin

from roms_tpu_torch.cases import obc_basin as tbasin

from torch_helpers import (assert_fields_close, assert_state_close, port_cfg,
                           run_jax, run_port)

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["radiating", "inflow"])
def test_obc_basin_three_steps_match_jax(mode):
    cfg = jbasin.config(mode).replace(nx=24, ny=20)
    kw = dict(inflow_u=0.2, t_inflow=2.0) if mode == "inflow" else {}
    jg, jst, jfrc = jbasin.setup(cfg, **kw)
    tg, tst, tfrc = tbasin.setup(port_cfg(cfg), device="cpu", **kw)
    for j, t in ((jg, tg), (jst, tst), (jfrc, tfrc)):
        assert_fields_close(j, t, 1e-13)
    ref = run_jax(cfg, jg, jst, jfrc)
    got = run_port(cfg, jg, jst, jfrc)
    assert_state_close(got, ref, 5e-11)
