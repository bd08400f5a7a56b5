"""Static model configuration (the port's own copy of roms_tpu/config.py).

The reference model is configured at compile time through CPP switches
(reference: src/cppdefs.opt) plus compile-time constants (reference:
src/param.opt) and runtime keywords parsed from roms.in (reference:
src/read_inp_mod.F:18-220).  Here all of that is one frozen dataclass,
field for field the same as the JAX package's, so a configuration made
for one package is rebuilt for the other by name
(`bench_h100.reference.bridge.config_from_dict`).  Standard library only.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from enum import Enum


class AdvScheme(Enum):
    """Horizontal advection flux scheme (reference: src/compute_horiz_tracer_fluxes.h:45-115).

    CENTERED4: 4-point symmetric 4th-order (predictor default).
    UPSTREAM3: 3-point upstream-biased parabolic (corrector default;
               reference: step3d_t_ISO.F:5 UPSTREAM_TS, step3d_uv1.F:3 UPSTREAM_UV).
    AKIMA:     harmonic-mean-slope variant.
    """

    CENTERED4 = "centered4"
    UPSTREAM3 = "upstream3"
    AKIMA = "akima"


@dataclass(frozen=True)
class ModelConfig:
    # ---- grid dimensions (reference: src/param.opt:18) -------------------
    nx: int  # LLm: physical interior points in XI
    ny: int  # MMm: physical interior points in ETA
    nz: int  # N:   vertical sigma levels
    nt: int = 1  # number of tracers (>= 1; itemp=0[, isalt=1])

    # ---- time stepping (reference: roms.in "time_stepping") --------------
    dt: float = 5.0  # baroclinic step [s]
    ndtfast: int = 60  # mode-splitting ratio; dtfast = dt/ndtfast
    ntimes: int = 20

    # ---- vertical coordinate (reference: roms.in "S-coord") --------------
    theta_s: float = 6.0
    theta_b: float = 2.0
    hc: float = 25.0  # critical depth [m]

    # ---- physical constants (reference: src/scalars.F:126-130) -----------
    g: float = 9.81
    rho0: float = 1000.0
    von_karman: float = 0.41

    # ---- EOS (reference: src/rho_eos.F; roms.in "lin_rho_eos") -----------
    nonlin_eos: bool = False  # Jackett & McDougall 1995 split EOS
    salinity: bool = False
    tcoef: float = 0.2  # thermal expansion [kg/m^3/degC] (linear EOS)
    t0: float = 1.0
    scoef: float = 0.822
    s0: float = 1.0

    # ---- bottom drag (reference: roms.in "bottom_drag") -------------------
    rdrg: float = 0.0  # linear drag coefficient [m/s]
    rdrg2: float = 1.0e-3  # quadratic drag (unused by log-layer law)
    zob: float = 1.0e-2  # bottom roughness height [m]

    # ---- mixing (reference: roms.in) --------------------------------------
    visc2: float = 0.0  # lateral Laplacian viscosity [m^2/s]
    tnu2: float = 0.0  # lateral Laplacian tracer diffusivity [m^2/s]
    akv_bak: float = 0.0  # background vertical viscosity [m^2/s]
    akt_bak: float = 0.0  # background vertical diffusivity [m^2/s]

    # ---- switches (reference: cppdefs.opt) --------------------------------
    uv_adv: bool = True  # UV_ADV
    uv_cor: bool = True  # UV_COR
    curvgrid: bool = False  # CURVGRID
    masking: bool = True  # MASKING
    ew_periodic: bool = True  # EW_PERIODIC
    ns_periodic: bool = True  # NS_PERIODIC
    uv_vis2: bool = True  # UV_VIS2 (no-op when visc2 == 0)
    ts_dif2: bool = True  # TS_DIF2 (no-op when tnu2 == 0)
    lmd_kpp: bool = False  # LMD_KPP vertical mixing
    var_rho_2d: bool = True  # VAR_RHO_2D (reference: set_global_definitions.h:81)
    # rotated (isoneutral) biharmonic tracer diffusion
    # (reference: ADV_ISONEUTRAL + SW_TRIADS + STABILIZE,
    # step3d_t_ISO.F:15-17 both sub-switches default on)
    adv_isoneutral: bool = False
    sw_triads: bool = True
    stabilize: bool = True

    # predictor/corrector advection schemes (see AdvScheme docstring)
    ts_pred_scheme: AdvScheme = AdvScheme.CENTERED4
    ts_corr_scheme: AdvScheme = AdvScheme.UPSTREAM3
    uv_pred_scheme: AdvScheme = AdvScheme.CENTERED4
    uv_corr_scheme: AdvScheme = AdvScheme.UPSTREAM3

    # ---- boundary conditions ----------------------------------------------
    gamma2: float = 1.0  # tangential wall slipperiness: +1 free-slip,
    #                      -1 no-slip (reference: roms.in "gamma2")
    river_source: bool = False  # RIVER_SOURCE point sources
    pipe_source: bool = False   # PIPE_SOURCE submerged sources

    # ---- open boundaries (reference: cppdefs.opt OBC_* switches) ----------
    obc_west: bool = False   # OBC_WEST
    obc_east: bool = False   # OBC_EAST
    obc_south: bool = False  # OBC_SOUTH
    obc_north: bool = False  # OBC_NORTH
    # barotropic scheme: OBC_M2FLATHER | OBC_M2ORLANSKI | OBC_M2SPECIFIED
    obc_m2: str = "flather"
    # baroclinic momentum: OBC_M3ORLANSKI | OBC_M3SPECIFIED
    obc_m3: str = "orlanski"
    # tracers: OBC_TORLANSKI | OBC_TSPECIFIED
    obc_t: str = "orlanski"
    frc_bry: bool = False  # Z/M2/M3/T_FRC_BRY: external boundary data active
    obc_rad_normal: bool = False  # OBC_RAD_NORMAL: 1D radiation only
    obc_rad_npo: bool = False     # OBC_RAD_NPO: no phase speed projection
    ubind: float = 0.1    # offshore binding velocity [m/s] (roms.in "ubind")
    attnm2: float = 0.0   # barotropic boundary restoring coefficient

    # ---- biogeochemistry (reference: cppdefs.opt MARBL/BIOLOGY_BEC2,
    # src/marbl_driver.F, src/bec2_driver.F) -------------------------------
    bgc_model: str = "none"  # "none" | registered name (e.g. "npzd")
    n_bgc: int = 0           # BGC tracer count; they occupy t[nt-n_bgc:]

    # ---- upscaling (reference: cppdefs.opt UPSCALING,
    # src/upscale_output.F): record boundary advective tracer fluxes ------
    upscale_output: bool = False

    # ---- non-hydrostatic pressure projection (reference: cppdefs.opt
    # NHMG, NHMG/src/nhmg.f90; off by default, like the reference ships) --
    non_hydrostatic: bool = False
    nh_iters: int = 40       # PCG iterations per projection (roms_tpu/nhmg.py)
    nh_sigma_terms: bool = True  # sigma-slope cross-terms in the NH operator
    #                             (reference: NHMG/src/mg_define_matrices.f90
    #                              full matrices; False = orthogonal approx)

    # ---- term-by-term budget diagnostics (reference: cppdefs.opt
    # DIAGNOSTICS, src/diagnostics.F) --------------------------------------
    tracer_diagnostics: bool = False
    uv_diagnostics: bool = False   # momentum budgets (diagnostics.F Udiag/Vdiag)

    # ---- surface flux corrections (reference: cppdefs.opt QCORRECTION /
    # SFLX_CORR, src/surf_flux.F:140-163): relax the surface heat /
    # salinity flux toward SST/SSS data with a piston velocity [m/s]
    qcorrection: bool = False
    sflx_corr: bool = False
    dsstdt: float = 1.1574e-5    # ~1 m/day
    dsssdt: float = 1.1574e-5

    # ---- sponge layer (reference: cppdefs.opt SPONGE, src/set_nudgcof.F) --
    sponge: bool = False
    v_sponge: float = 0.0      # peak sponge viscosity/diffusivity [m^2/s]
    sponge_size: int = 15      # interior points in the sponge band

    # ---- halo -------------------------------------------------------------
    halo: int = 2  # ghost cells per side (reference: set_global_definitions.h:146)

    # ---- mesh-divisibility padding ------------------------------------------
    # Inert columns/rows appended AFTER the padded-global array's east/north
    # ghost ring so arbitrary grids shard onto an equal-block mesh (the
    # reverse of the reference's edge-rank remainder absorption,
    # reference: src/mpi_setup.F:115-155).  Padded cells carry rmask=0 and
    # replicated metrics; every end-relative (east/north) physical-edge
    # index in the kernels shifts by these STATIC offsets.  Nonzero only
    # inside the distributed step's per-block view (set by
    # parallel.dist.pad_for_mesh); the single-device path always runs 0.
    pad_e: int = 0
    pad_n: int = 0

    # ---- coupling constants ------------------------------------------------
    # Fast-flux extrapolation weights (reference: src/set_depth.F:314-316,
    # "PAC23 verified setting", alpha_max = 1.0877).
    extrap_now: float = 3.63
    extrap_mid: float = 4.47
    extrap_bak: float = 2.05

    # FlxU/FlxV n+1/2 blend in the corrector coupling
    # (reference: src/step3d_uv2.F:553-554).
    coup_delta: float = 0.28
    coup_epsil: float = 0.36

    @property
    def dtfast(self) -> float:
        return self.dt / float(self.ndtfast)

    @property
    def fully_periodic(self) -> bool:
        return self.ew_periodic and self.ns_periodic

    @property
    def any_obc(self) -> bool:
        return self.obc_west or self.obc_east or self.obc_south or self.obc_north

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def itemp(self) -> int:
        return 0

    @property
    def isalt(self) -> int:
        return 1

    @property
    def i_t_and_s(self) -> int:
        """Number of physical (T,S) tracers: Akt index clamp
        (reference: src/tracers.F iTandS)."""
        return 2 if self.salinity else 1
