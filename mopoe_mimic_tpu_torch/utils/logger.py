"""The port's logger (mopoe_mimic_tpu/utils/logger.py): INFO and above to
stderr. Modules that log through ``logging.getLogger(__name__)`` reach it
as its children. The JAX package's rotating DEBUG file under the home
directory is not kept: the port writes nothing outside its run
directories."""

from __future__ import annotations

import logging

log = logging.getLogger("mopoe_mimic_tpu_torch")


def configure(level: int = logging.INFO) -> logging.Logger:
    if log.handlers:
        return log
    log.setLevel(level)
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    log.addHandler(handler)
    return log


configure()
