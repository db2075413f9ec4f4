"""Failure types (mopoe_mimic_tpu/utils/exceptions.py; reference
mimic/utils/exceptions.py:1-6). ``DeviceOutOfMemory`` is what the batch
autotune's probe raises when a step does not fit on the card
(``train/autotune.py``); the CLI's backoff (``main.py``) also catches
``torch.cuda.OutOfMemoryError`` itself."""


class NaNInLatent(Exception):
    pass


class DeviceOutOfMemory(Exception):
    pass
