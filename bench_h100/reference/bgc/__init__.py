"""Biogeochemistry: plug-in coupling surface + built-in reduced ecosystems
(port of roms_tpu/bgc; reference: src/marbl_driver.F, src/bec2_driver.F)."""

from bench_h100.reference.bgc.api import (BGCContext, BGCModel,  # noqa: F401
                                    get_model, register)
