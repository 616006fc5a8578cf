"""egotap_tpu_torch — EgoTAP in PyTorch for NVIDIA Hopper: the serving
forward, the training and eval steps of both stages, the stage-1
targets rendered on the device, and the train and test CLIs
(`cli/train.py`, `cli/test.py`) with their loaders, checkpoints and
evaluation.

A port of `egotap_tpu` (the JAX/Pallas package, which stays the
reference) to PyTorch and hand-written CUDA kernels for one H100.
Module names mirror the JAX package (`models/vit.py` <->
`egotap_tpu/models/vit.py`); public functions keep the JAX layouts
(NHWC images and heatmaps, packed ``(B, S, H*Dh)`` attention operands,
``(B, J, F)`` joint features) so the two compare like with like.

Kernels live in ``csrc/*.cu`` and are built with ``nvcc`` at first use
(`ops/_build.py`). Each kernel wrapper runs its plain PyTorch version
only for a CPU tensor; for a CUDA tensor it launches the kernel or
raises. Entry points (`serving.Predictor`, `train.tasks.HeatmapTask`,
`train.tasks.LifterTask`, `train.tasks.create_task`,
`train.loop.train_main`, `eval.evaluate.evaluate` and the CLIs' `main`)
default to ``device="cuda"``.

This package imports neither ``jax`` nor anything of ``egotap_tpu``.
"""

__version__ = "0.1.0"
