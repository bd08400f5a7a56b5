"""Configuration consistency audit, the cppcheck / srcscheck analog (port
of roms_tpu/audit.py).

The reference's build runs `cppcheck` + `srcscheck` over the CPP-switch
matrix to reject inconsistent compile configurations before they can
produce silently-wrong physics (reference: src/Makefile checks,
Documentation 'setup check' flow; the runtime partner is check_srcs /
setup_kwds in read_inp).  Here the whole switch surface is one typed
`ModelConfig`, so the audit is a plain function: it returns a list of
(severity, message) findings — "error" for combinations that are
physically inconsistent or silently ignored, "warn" for legal-but-
suspicious setups.  `read_inp`-driven runs call it automatically
(strict mode raises on errors, mirroring the reference's hard abort)."""

from __future__ import annotations

from typing import List, Tuple

from roms_tpu_torch.config import ModelConfig

Finding = Tuple[str, str]   # ("error" | "warn", message)


def audit_config(cfg: ModelConfig) -> List[Finding]:
    out: List[Finding] = []

    def err(msg):
        out.append(("error", msg))

    def warn(msg):
        out.append(("warn", msg))

    # --- tracer bookkeeping -------------------------------------------
    if cfg.salinity and cfg.nt < 2:
        err(f"salinity=True needs nt >= 2 (isalt=1), got nt={cfg.nt}")
    if cfg.n_bgc > 0 and cfg.bgc_model == "none":
        err(f"n_bgc={cfg.n_bgc} but bgc_model='none' — the BGC tracers "
            "would advect with no source terms")
    if cfg.bgc_model != "none" and cfg.n_bgc == 0:
        err(f"bgc_model={cfg.bgc_model!r} but n_bgc=0 — the model would "
            "never be called")
    if cfg.n_bgc > 0:
        nphys = cfg.nt - cfg.n_bgc
        if nphys < (2 if cfg.salinity else 1):
            err(f"nt={cfg.nt} leaves {nphys} physical tracers for "
                f"n_bgc={cfg.n_bgc}; need at least T"
                + (" and S" if cfg.salinity else ""))
    if cfg.sflx_corr and not cfg.salinity:
        err("sflx_corr (SSS restoring) requires salinity=True")
    if cfg.adv_isoneutral and not cfg.nonlin_eos:
        warn("adv_isoneutral with the linear EOS: neutral slopes reduce "
             "to constant-alpha surfaces (reference runs ISO with the "
             "split nonlinear EOS)")

    # --- boundaries ----------------------------------------------------
    if cfg.ew_periodic and (cfg.obc_west or cfg.obc_east):
        err("ew_periodic with obc_west/obc_east: a periodic axis cannot "
            "carry open boundaries (reference: EW_PERIODIC excludes "
            "OBC_WEST/EAST, cppdefs)")
    if cfg.ns_periodic and (cfg.obc_south or cfg.obc_north):
        err("ns_periodic with obc_south/obc_north is inconsistent")
    if cfg.frc_bry and not cfg.any_obc:
        warn("frc_bry=True but no obc_* edge is open — boundary data "
             "will be read and ignored")
    if cfg.any_obc and cfg.obc_m2 == "flather" and not cfg.frc_bry:
        warn("Flather barotropic OBC without frc_bry: external data "
             "defaults to the initial edge state")
    for name, val, menu in (("obc_m2", cfg.obc_m2,
                             ("flather", "specified", "orlanski")),
                            ("obc_m3", cfg.obc_m3,
                             ("orlanski", "specified")),
                            ("obc_t", cfg.obc_t,
                             ("orlanski", "specified"))):
        if cfg.any_obc and val not in menu:
            err(f"{name}={val!r} not in {menu}")

    # --- mode splitting / stability -----------------------------------
    if cfg.ndtfast < 10:
        warn(f"ndtfast={cfg.ndtfast} < 10: the FB weight filter is "
             "designed for 30-60 sub-steps (reference: set_weights.F)")
    if cfg.dtfast <= 0.0:
        err("dtfast <= 0")

    # --- mixing / physics menus ---------------------------------------
    if cfg.lmd_kpp and cfg.akv_bak == 0.0 and cfg.akt_bak == 0.0:
        warn("lmd_kpp with zero akv_bak/akt_bak backgrounds: interior "
             "columns outside mixing events get exactly zero diffusivity "
             "(the reference ships nonzero backgrounds, lmd_vmix.F)")
    if cfg.uv_vis2 and cfg.visc2 == 0.0 and not cfg.sponge:
        pass  # legal: viscosity purely from sponges or disabled
    if cfg.sponge and cfg.v_sponge <= 0.0:
        warn("sponge=True with v_sponge <= 0: the sponge band adds "
             "nothing")
    if cfg.non_hydrostatic and cfg.nh_iters < 5:
        warn(f"non_hydrostatic with nh_iters={cfg.nh_iters}: the PCG "
             "will not converge meaningfully")

    # --- surface forcing ----------------------------------------------
    if cfg.qcorrection and cfg.dsstdt <= 0.0:
        warn("qcorrection with non-positive dsstdt")

    # --- decomposition-related ----------------------------------------
    if (cfg.pad_e or cfg.pad_n) and not cfg.masking:
        err("mesh-divisibility padding requires masking=True (padded "
            "cells are carried as inert land)")
    return out


def check_config(cfg: ModelConfig, strict: bool = True) -> List[Finding]:
    """Audit + report.  strict: raise on errors (the reference aborts in
    its setup checks); warnings always print once."""
    findings = audit_config(cfg)
    errors = [m for s, m in findings if s == "error"]
    for s, m in findings:
        if s == "warn":
            import warnings
            warnings.warn(f"config audit: {m}", stacklevel=2)
    if strict and errors:
        raise ValueError("config audit failed:\n  - " +
                         "\n  - ".join(errors))
    return findings
