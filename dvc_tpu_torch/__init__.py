"""dvc_tpu_torch — the PyTorch/CUDA port of ``dvc_tpu`` for NVIDIA Hopper.

The JAX package ``dvc_tpu`` is the reference; this package mirrors its
module names so the counterpart of each module is easy to find:

  ops/       hand-written CUDA kernels (``csrc/``) behind thin wrappers, each
             beside its plain PyTorch version: trunk multi-scale deformable
             attention and the fused greedy caption decode
  models/    FusionPDVC eval forward (fusion blocks, conv pyramid,
             deformable transformer, LSTM-DSA greedy head), postprocessing,
             and the flax -> torch ``state_dict`` converter
  data/      the feature rescale and the shared vocabulary ``Translator``
  utils/     box ops and the shared config loader
  serve.py   ``DenseCaptioner``, the serving API

This package imports ``torch`` and ``numpy`` and never ``jax`` nor the
``dvc_tpu`` package: the few framework-free files it shares with
``dvc_tpu`` (the config system, the vocabulary) are loaded by their paths.
"""

__version__ = "0.1.0"
