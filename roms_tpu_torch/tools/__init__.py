"""Offline host tools (port of roms_tpu/tools; reference: Tools-Roms/):
grid generation, sampling and depth slices of history files, ROMS-to-ROMS
nesting, splitting and joining per-rank files (partit, ncjoin), and
NetCDF-3 to compressed NetCDF-4 conversion.  All numpy on the host.

CLI entry points:
    python -m roms_tpu_torch.tools.grid_gen out.nc --center LON LAT ...
    python -m roms_tpu_torch.tools.sample hist.nc --var temp --depths 10
    python -m roms_tpu_torch.tools.nc3to4z file.nc ...
    python -m roms_tpu_torch.tools.partition partit NP_XI NP_ETA file.nc
    python -m roms_tpu_torch.tools.partition ncjoin out.nc file.*.nc
"""
