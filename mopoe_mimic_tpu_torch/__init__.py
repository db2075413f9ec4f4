"""PyTorch / CUDA port of mopoe_mimic_tpu for NVIDIA Hopper GPUs.

The JAX package ``mopoe_mimic_tpu`` is the reference this package is held
against. This package imports ``torch`` and numpy only: it never imports
``jax``, never imports a module of ``mopoe_mimic_tpu`` (whose package
``__init__`` loads jax and flax) and reads none of its files. It runs from a
tree without ``mopoe_mimic_tpu/``: ``config.py`` here is its own copy of the
stdlib-only ``mopoe_mimic_tpu/config.py`` (same fields and defaults).

Layout mirrors the JAX package:

  * ``ops/``     fusion, KL divergences, log-probabilities, sampling, the
                 fused text head and the fused BN → ReLU → 1×1 conv (plain
                 PyTorch), and the hand-written CUDA kernels beside them:
                 the subset PoE forward and backward (``ops/cuda_fusion.py``
                 + ``csrc/poe_subsets.cu``), the fused text head
                 (``ops/cuda_texthead.py`` + ``csrc/texthead.cu``) and the
                 fused BN → ReLU → 1×1 conv (``ops/cuda_pointwise.py`` +
                 ``csrc/pointwise.cu``)
  * ``models/``  residual blocks, image and word-text networks, MMVae, and
                 the JAX → PyTorch weight converter
  * ``data/``    the synthetic dataset, the host-fed ``BatchLoader`` and the
                 card-resident ``DeviceStore`` (copies and ports of the JAX
                 package's numpy-only data modules)
  * ``train/``   the objective, the train state and optimizer, the train
                 and eval steps and their bodies, and the epoch runners
                 (``train/scan.py``: a CUDA graph of a step, replayed per
                 batch of the store)
  * ``serve.py`` the inference session and its CLI

Module names use the reference's ``state_dict`` keys
(``mopoe_mimic_tpu/models/torch_import.py:91-110``), so
``convert_mopoe_state_dict(model.state_dict(), cfg)`` yields MMVae variables.
"""
