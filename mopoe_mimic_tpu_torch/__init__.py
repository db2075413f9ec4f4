"""PyTorch / CUDA port of mopoe_mimic_tpu for NVIDIA Hopper GPUs.

The JAX package ``mopoe_mimic_tpu`` is the reference this package is held
against. This package imports ``torch`` and numpy only: it never imports
``jax`` and never imports a module of ``mopoe_mimic_tpu`` (whose package
``__init__`` loads jax and flax). The one shared file, the stdlib-only
``mopoe_mimic_tpu/config.py``, is loaded by path (``config.py`` here).

Layout mirrors the JAX package:

  * ``ops/``     fusion, KL divergences, log-probabilities, sampling and
                 the fused text head (plain PyTorch), and the hand-written
                 CUDA kernels beside them: the subset PoE forward and
                 backward (``ops/cuda_fusion.py`` + ``csrc/poe_subsets.cu``)
                 and the fused text head (``ops/cuda_texthead.py`` +
                 ``csrc/texthead.cu``)
  * ``models/``  residual blocks, image and word-text networks, MMVae, and
                 the JAX → PyTorch weight converter
  * ``train/``   the objective, the train state and optimizer, the train
                 and eval steps
  * ``serve.py`` the inference session and its CLI

Module names use the reference's ``state_dict`` keys
(``mopoe_mimic_tpu/models/torch_import.py:91-110``), so
``convert_mopoe_state_dict(model.state_dict(), cfg)`` yields MMVae variables.
"""
