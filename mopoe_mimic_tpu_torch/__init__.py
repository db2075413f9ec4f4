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
  * ``models/``  residual blocks, image and text networks (char-1024, word
                 at 128 and >= 512), MMVae, and the JAX → PyTorch weight
                 converter
  * ``data/``    the synthetic dataset, the host-fed ``BatchLoader``, the
                 card-resident ``DeviceStore``, the char codec and the word
                 vocabulary (copies and ports of the JAX package's
                 numpy-only data modules)
  * ``train/``   the objective, the train state and optimizer, the train
                 and eval steps and their bodies, the epoch runners
                 (``train/scan.py``: a CUDA graph of a step, replayed per
                 batch of the store), the epoch loop (``train/loop.py``:
                 ``run_epochs``), its callbacks (LR plateau, early stop,
                 checkpoint cadence) and the batch autotune
  * ``utils/``   checkpoints with resume and best-k retention, the results
                 CSV, TensorBoard, metric meters, the run directory, the
                 logger, the preemption guard, profiling and sample grids
                 as PNG files
  * ``experiment.py`` the experiment: datasets, data feeds, train state,
                 run directory and sinks
  * ``main.py``  the training CLI (``python -m mopoe_mimic_tpu_torch.main``):
                 NaN restarts, the out-of-memory backoff, ``--load_run``
  * ``serve.py`` the inference session (a run directory or a config and a
                 state_dict) and its CLI (``python -m
                 mopoe_mimic_tpu_torch.serve --run_dir RUN``)
  * ``serve_http.py`` the HTTP server over the session

Module names use the reference's ``state_dict`` keys
(``mopoe_mimic_tpu/models/torch_import.py:91-110``), so
``convert_mopoe_state_dict(model.state_dict(), cfg)`` yields MMVae variables.
"""
