"""Physical boundary conditions (port of roms_tpu/ops/bc.py, periodic
part only).

On a doubly periodic configuration every boundary routine of the JAX
package returns its first argument unchanged (roms_tpu/ops/bc.py:165,
284, 479, 636, 735, 846); that is all this slice needs.  Open and closed
boundaries are not ported yet and raise.
"""

from __future__ import annotations

from roms_tpu_torch.config import ModelConfig

_TODO = "open/closed boundaries: ROADMAP Queue 1 item 5"


def _periodic_only(a, cfg: ModelConfig):
    if cfg.fully_periodic:
        return a
    raise NotImplementedError(_TODO)


def zetabc(z_new, z_stp, grid, cfg: ModelConfig, bry=None):
    return _periodic_only(z_new, cfg)


def u2dbc(ubar_new, ubar_stp, vbar_stp, z_new, z_stp, grid,
          cfg: ModelConfig, bry=None):
    return _periodic_only(ubar_new, cfg)


def v2dbc(vbar_new, vbar_stp, ubar_stp, z_new, z_stp, grid,
          cfg: ModelConfig, bry=None):
    return _periodic_only(vbar_new, cfg)


def u3dbc(u_new, u_stp, u_rhs, v_rhs, grid, cfg: ModelConfig, bry=None,
          pred_stage: bool = False):
    return _periodic_only(u_new, cfg)


def v3dbc(v_new, v_stp, u_rhs, v_rhs, grid, cfg: ModelConfig, bry=None,
          pred_stage: bool = False):
    return _periodic_only(v_new, cfg)


def t3dbc(t_new, t_stp, u_rhs, v_rhs, grid, cfg: ModelConfig, bry=None,
          pred_stage: bool = False):
    return _periodic_only(t_new, cfg)
