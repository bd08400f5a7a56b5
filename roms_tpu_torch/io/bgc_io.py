"""BGC diagnostics output, the `bgc_io.F` analog (port of
roms_tpu/io/bgc_io.py).

The reference registers ~100 per-rate 2D/3D BGC diagnostics (air-sea CO2
flux, pH, PAR, production/remineralization/flux rates) and writes them to
their own `*_bgc_dia.nc` files at output cadence (reference: src/bgc_io.F
wrt_bgc_diag; registration src/bec2_vars.F diag tables).  Here the BGC
model's `diagnose` function (bgc/api.py) evaluates the full registered
rate set from the live state, only at write time, so the step loop pays
nothing.
"""

from __future__ import annotations

from typing import Optional

from roms_tpu_torch.bgc.api import BGCContext, get_model
from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.io.netcdf import NCWriter
from roms_tpu_torch.io.output import host, provenance_attrs

RHO = slice(1, -1)      # padded (n+4) -> joined-file (n+2) rho range

# metadata for the registered diagnostics (name -> (long_name, units));
# anything the model emits beyond this table still gets written, with
# placeholder metadata
DIAG_META = {
    "PAR": ("photosynthetically available radiation", "W/m2"),
    "photoC_sp": ("small-phyto C fixation", "mmol C/m3/s"),
    "photoC_diat": ("diatom C fixation", "mmol C/m3/s"),
    "photoC_diaz": ("diazotroph C fixation", "mmol C/m3/s"),
    "photoC_tot": ("total primary production", "mmol C/m3/s"),
    "graze_tot": ("total zooplankton grazing", "mmol C/m3/s"),
    "zoo_loss": ("zooplankton mortality", "mmol C/m3/s"),
    "DOC_prod": ("semi-labile DOC production", "mmol C/m3/s"),
    "DOC_remin": ("semi-labile DOC remineralization", "mmol C/m3/s"),
    "POC_prod": ("POC production", "mmol C/m3/s"),
    "POC_remin": ("POC remineralization", "mmol C/m3/s"),
    "POC_flux": ("downward POC flux at W-interfaces", "mmol C/m2/s"),
    "POC_bot_flux": ("POC flux through the sea floor", "mmol C/m2/s"),
    "CaCO3_prod": ("CaCO3 production", "mmol C/m3/s"),
    "CaCO3_remin": ("CaCO3 dissolution", "mmol C/m3/s"),
    "CaCO3_flux": ("downward CaCO3 flux at W-interfaces", "mmol C/m2/s"),
    "CaCO3_bot_flux": ("CaCO3 flux through the sea floor", "mmol C/m2/s"),
    "SiO2_prod": ("biogenic silica production", "mmol Si/m3/s"),
    "SiO2_remin": ("biogenic silica dissolution", "mmol Si/m3/s"),
    "SiO2_flux": ("downward bSi flux at W-interfaces", "mmol Si/m2/s"),
    "Fe_scavenge": ("iron scavenging", "mmol Fe/m3/s"),
    "N_fix": ("nitrogen fixation", "mmol N/m3/s"),
    "NO3_uptake": ("NO3 uptake", "mmol N/m3/s"),
    "NH4_uptake": ("NH4 uptake", "mmol N/m3/s"),
    "NITRIF_NH4_NO2": ("nitrification NH4->NO2", "mmol N/m3/s"),
    "NITRIF_NO2_NO3": ("nitrification NO2->NO3", "mmol N/m3/s"),
    "NITRIF_NH4_NO3": ("nitrification NH4->NO3", "mmol N/m3/s"),
    "DENITRIF": ("suboxic denitrification", "mmol N/m3/s"),
    "N2O_prod": ("N2O production", "mmol N2O/m3/s"),
    "pCO2_oc": ("surface ocean pCO2", "uatm"),
    "pH_surf": ("surface pH", "1"),
    "FG_CO2": ("air-sea CO2 flux (positive into ocean)", "mmol C/m2/s"),
    "FG_O2": ("air-sea O2 flux (positive into ocean)", "mmol O2/m2/s"),
    "O2_saturation": ("surface O2 saturation", "mmol O2/m3"),
    "wspd_10m": ("10 m wind speed used for gas exchange", "m/s"),
}



def make_bgc_context(state, forcing, grid, cfg: ModelConfig) -> BGCContext:
    """BGCContext from a live state, built as the step's BGC coupling
    builds it (stepper.bgc_update)."""
    return BGCContext(
        temp=state.t[cfg.itemp],
        salt=state.t[cfg.isalt] if cfg.salinity else None,
        z_r=state.z_r, z_w=state.z_w, hz=state.hz,
        srflx=forcing.srflx, swr_frac=state.swrf, rmask=grid.rmask,
        dt=cfg.dt, time=state.time)


class BgcDiagWriter:
    """Streaming `*_bgc_dia.nc` writer (reference: bgc_io.F wrt_bgc_diag).

    Variables are created from the first diagnose() evaluation, so any
    model-registered diagnostic is written without a code change."""

    def __init__(self, path: str, grid, cfg: ModelConfig,
                 model_name: Optional[str] = None, dtype: str = "f4"):
        self.cfg = cfg
        self.dtype = dtype
        self.model = get_model(model_name or cfg.bgc_model)
        if self.model.diagnose is None:
            raise ValueError(
                f"BGC model {self.model.name!r} registers no diagnostics")
        attrs = provenance_attrs(cfg)
        attrs["contents"] = "BGC rate diagnostics (bgc_io analog)"
        self.nc = NCWriter(path, attrs)
        self.nc.create_dim("time", None)
        self.nc.create_dim("s_rho", cfg.nz)
        self.nc.create_dim("s_w", cfg.nz + 1)
        self.nc.create_dim("eta_rho", cfg.ny + 2)
        self.nc.create_dim("xi_rho", cfg.nx + 2)
        self.nc.create_var("ocean_time", ("time",), "f8",
                           {"long_name": "time since initialization",
                            "units": "second"})
        self._created = False
        self.rec = 0
        self.grid = grid

    def _dims_of(self, a):
        if a.ndim == 2:
            return ("time", "eta_rho", "xi_rho")
        if a.shape[0] == self.cfg.nz:
            return ("time", "s_rho", "eta_rho", "xi_rho")
        return ("time", "s_w", "eta_rho", "xi_rho")

    def write(self, state, forcing):
        cfg = self.cfg
        i0 = cfg.nt - cfg.n_bgc
        ctx = make_bgc_context(state, forcing, self.grid, cfg)
        forc = dict(forcing.bgc) if forcing.bgc else {}
        diags = self.model.diagnose(state.t[i0:], ctx, forc)
        diags = {k: host(v) for k, v in diags.items()}
        if not self._created:
            for name in sorted(diags):
                lname, units = DIAG_META.get(name, (name, "?"))
                self.nc.create_var(name, self._dims_of(diags[name]),
                                   self.dtype,
                                   {"long_name": lname, "units": units})
            self._created = True
        self.nc.write("ocean_time", float(state.time), rec=self.rec)
        for name, a in diags.items():
            self.nc.write(name, a[..., RHO, RHO].astype(self.dtype),
                          rec=self.rec)
        self.rec += 1
        self.nc.sync()

    def close(self):
        self.nc.close()
