"""The port's monitor (`roms_tpu_torch/monitor.py`) and `driver.run`'s
`error_log`, `timers` and `ninfo` wiring, mirroring tests/test_monitor.py
(reference: src/timers.F, src/error_handling_mod.F90, src/diag.F blowup
detection), on the CPU in float64."""

import time

import numpy as np
import pytest
import torch

from roms_tpu.cases import filament as jfilament
from roms_tpu.driver import _diag_due as jdiag_due
from roms_tpu.driver import run as jrun

from roms_tpu_torch import bridge
from roms_tpu_torch.cases import filament
from roms_tpu_torch.driver import _diag_due, run
from roms_tpu_torch.monitor import (BlowupError, ErrorLog, RomsAbort, Timers,
                                    check_blowup)

from torch_helpers import np_tree, port_cfg

torch.set_num_threads(1)


def test_error_log_scopes_and_abort():
    log = ErrorLog()
    assert not log.abort_requested
    log.abort_check()  # no-op when clean
    log.raise_global("setup", "bad config")
    log.raise_from_rank("halo", "short message", rank=3)
    log.raise_from_point("rho_eos", "negative density", 3, 4, 5)
    assert log.abort_requested
    with pytest.raises(RomsAbort) as e:
        log.abort_check()
    assert "bad config" in str(e.value)
    assert "(3, 4, 5)" in str(e.value)
    assert "[rank] halo: short message at (3,)" in str(e.value)


def test_blowup_detection():
    check_blowup((1e-5, 1e-6, 0.01), 3)  # finite: fine
    with pytest.raises(BlowupError):
        check_blowup((np.nan, 1e-6, 0.01), 4)
    with pytest.raises(BlowupError):
        check_blowup((np.inf, 1e-6, 0.01), 5)
    log = ErrorLog()
    with pytest.raises(BlowupError):
        check_blowup((np.nan,), 6, log)
    assert log.abort_requested
    assert "BLOWUP at step 6" in log.entries[0].info


def test_timers_phases():
    t = Timers()
    t.tic("step2d")
    time.sleep(0.01)
    t.toc("step2d")
    t.tic("step2d")
    time.sleep(0.01)
    # a CPU tensor needs no device wait
    t.toc("step2d", sync=torch.zeros(3))
    assert t.phases["step2d"] >= 0.02
    assert t.calls == {"step2d": 2}
    b = t.banner()
    assert "run_time" in b and "step2d" in b and "2 calls" in b


def test_diag_schedule_log_ramp():
    """ninfo>1: power-of-two ramp then every ninfo (reference
    diag.F:36-41), as the JAX package's schedule."""
    due = [i for i in range(33) if _diag_due(i, 10)]
    assert due == [0, 1, 2, 4, 8, 10, 20, 30]
    assert all(_diag_due(i, 1) for i in range(5))
    for ninfo in (1, 3, 10, 16):
        assert [_diag_due(i, ninfo) for i in range(70)] == \
            [jdiag_due(i, ninfo) for i in range(70)]


def test_run_ninfo_and_error_log_wiring():
    """The driver honors ninfo (fewer diag rows, no per-step sync), fills
    the timers, matches the JAX package's rows, and queues blowups into an
    ErrorLog before raising."""
    jcfg = jfilament.config().replace(nx=16, ny=16, nz=4, ntimes=5)
    jgrid, jst, jfrc = jfilament.setup(jcfg)
    cfg = port_cfg(jcfg)
    grid = bridge.grid_from_numpy(np_tree(jgrid), dtype=torch.float64,
                                  device="cpu")
    st = bridge.state_from_numpy(np_tree(jst), dtype=torch.float64,
                                 device="cpu")
    frc = bridge.forcing_from_numpy(np_tree(jfrc), dtype=torch.float64,
                                    device="cpu")
    timers = Timers()
    _, rows = run(grid, st, frc, cfg, nsteps=5, ninfo=4, timers=timers)
    assert [int(r[0]) for r in rows] == [0, 1, 2, 4]
    assert timers.nsteps == 5 and timers.phases["step"] > 0.0
    _, jrows = jrun(jgrid, jst, jfrc, jcfg, nsteps=5, ninfo=4)
    np.testing.assert_allclose(rows, jrows, rtol=1e-12, atol=0)

    # blowup queues into the log and still raises
    st_bad = st.replace(u=st.u + torch.nan)
    log = ErrorLog()
    with pytest.raises(BlowupError):
        run(grid, st_bad, frc, cfg, nsteps=2, error_log=log)
    assert log.abort_requested
    with pytest.raises(RomsAbort):
        log.abort_check()


def test_run_drains_a_hook():
    """A step hook with `.drain()` is drained once, after the last step
    (roms_tpu/driver.py:112-113)."""
    cfg = filament.config().replace(nx=8, ny=8, nz=4, ntimes=2)
    grid, st, frc = filament.setup(cfg, device="cpu")
    calls = []

    def hook(state, i):
        calls.append(i)

    hook.drain = lambda: calls.append("drain")
    run(grid, st, frc, cfg, nsteps=2, step_hook=hook, collect_diag=False)
    assert calls == [1, 2, "drain"]
