"""Host-side input: NetCDF reading and writing, the grid and initial-state
readers, and the background record reader of the forcing engine (port of
roms_tpu/io; reference: src/nc_read_write.F, src/roms_read_write.F)."""
