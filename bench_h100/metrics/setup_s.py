"""Set-up: from the start of the process to the first timed step
(imports, the kernel library built or loaded from build/, the inputs
made, the program's derivation of its state, the warm-up steps)."""

UNIT = "s"


def read(run):
    return run.setup_s
