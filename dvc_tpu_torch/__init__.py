"""dvc_tpu_torch — the PyTorch/CUDA port of ``dvc_tpu`` for NVIDIA Hopper.

The JAX package ``dvc_tpu`` is the reference; this package mirrors its
module names so the counterpart of each module is easy to find:

  ops/          hand-written CUDA kernels (``csrc/``) behind thin wrappers,
                each beside its plain PyTorch version: trunk multi-scale
                deformable attention (forward and backward), the fused
                greedy caption decode, and the teacher-forcing word scan
                (forward and backward)
  models/       PDVC and FusionPDVC eval and train forwards (fusion
                blocks, conv pyramid, deformable transformer, two-stage
                queries, the LSTM-DSA and light caption heads), matcher,
                criterion, postprocessing, and the flax -> torch
                ``state_dict`` converter
  data/         feature datasets, static collation, the vocabulary
  eval/         the metric stack (pure-Python BLEU/METEOR/ROUGE-L/CIDEr,
                dense-captioning 2018/2021, SODA, paragraph) and the
                evaluation loop ``evaluate``
  train/        ``Trainer``: AdamW/Adam step, eval step, LR schedule,
                checkpoints
  parallel/     data-parallel training, one process a card (the JAX
                data mesh's counterpart): each rank's rows, the global
                sums of the losses' counts, the gradients and BatchNorm's
                statistics, the launch (spawned ranks or ``torchrun``)
  utils/        box ops and the config system (``cfgs/*.yml``)
  new_train.py  FusionPDVC training with validation
                (``python -m dvc_tpu_torch.new_train``)
  run_train.py  plain PDVC training with validation, the counterpart of
                the root ``train.py``
                (``python -m dvc_tpu_torch.run_train``)
  run_eval.py   evaluation, the counterpart of the root ``eval.py``
                (``python -m dvc_tpu_torch.run_eval``)
  serve.py      ``DenseCaptioner``, the serving API, and ``load_run``

This package imports ``torch``, ``numpy`` and ``scipy`` and never ``jax``
nor the ``dvc_tpu`` package: it keeps its own copies of the framework-free
code it shares with ``dvc_tpu`` (the config system, the vocabulary, the
metric stack).  Its entry points run on the card unless the caller asks
for the CPU.
"""

__version__ = "0.1.0"
