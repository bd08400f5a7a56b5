"""Throughput: grid points (nx * ny * nz) times the baroclinic steps of
the window over its wall seconds, in millions; the window is one
`driver.run` call timed on the host clock between two synchronizes."""

UNIT = "Mpoint-steps/s"


def read(run):
    c = run.cfg
    return c.nx * c.ny * c.nz * run.window_steps / run.window_s / 1e6
