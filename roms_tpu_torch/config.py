"""Static model configuration, shared with the JAX package.

`ModelConfig` and `AdvScheme` are the very objects of roms_tpu/config.py,
so a configuration made for one package drives the other.  That module
imports only the standard library (no jax); every module of the port
takes its configuration names from here, so this is the one place where
the port reaches into `roms_tpu` for them.
"""

from roms_tpu.config import AdvScheme, ModelConfig

__all__ = ["AdvScheme", "ModelConfig"]
