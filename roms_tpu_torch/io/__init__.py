"""I/O subsystem: NetCDF read/write, the grid and initial-state readers,
history/average/restart output and the background reader and writer
threads (port of roms_tpu/io; reference: src/nc_read_write.F,
src/roms_read_write.F, src/basic_output.F)."""

from roms_tpu_torch.io.netcdf import NCDataset, NCWriter, open_dataset  # noqa: F401
from roms_tpu_torch.io.output import (AverageWriter, HistoryWriter,  # noqa: F401
                                      read_restart, write_grid,
                                      write_restart)
from roms_tpu_torch.io.input import read_grid, read_init  # noqa: F401
