"""The JAX package's ``MopoeConfig`` / ``Method``, loaded by file path.

``mopoe_mimic_tpu/config.py`` needs only the standard library, but
importing it as ``mopoe_mimic_tpu.config`` runs the package ``__init__``,
which loads jax and flax. Loading the file directly gives the port the
same dataclass, field names and defaults, so it reads the ``config.json``
a JAX run writes, with no copy to drift from the original.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_MODULE_NAME = "mopoe_mimic_tpu_torch._reference_config"
_CONFIG_PATH = Path(__file__).resolve().parent.parent / "mopoe_mimic_tpu" / "config.py"


def _load():
    mod = sys.modules.get(_MODULE_NAME)
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(_MODULE_NAME, _CONFIG_PATH)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load the reference config from {_CONFIG_PATH}")
    mod = importlib.util.module_from_spec(spec)
    # dataclasses resolves the module through sys.modules while the class
    # body executes, so register before exec_module
    sys.modules[_MODULE_NAME] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[_MODULE_NAME]
        raise
    return mod


_cfg_module = _load()
MopoeConfig = _cfg_module.MopoeConfig
Method = _cfg_module.Method

__all__ = ["MopoeConfig", "Method"]
