"""Run-folder management and logging (the port's copy of
``dvc_tpu/utils/logging.py``; reference ``misc/utils.py``).

``build_folder`` picks a run's folder (reference ``build_floder``,
misc/utils.py:105-126); ``backup_environment`` copies the recipes and the
sources into it (``backup_envir``, misc/utils.py:129-135);
``create_logger`` logs to the console and a file; ``MetricsWriter``
writes scalar metrics as JSON lines (and TensorBoard events where
``tensorboardX`` imports); ``print_opt`` logs the option table.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import sys


def build_folder(opt) -> str:
    """save_dir/id, renamed id_v_N on a collision, or the folder of
    ``--start_from`` (reference ``misc/utils.py:105-126``)."""
    if opt.start_from:
        save_folder = os.path.join(opt.save_dir, opt.start_from)
        if not os.path.exists(save_folder):
            raise FileNotFoundError(f'the folder {save_folder} does not exist')
        return save_folder
    save_folder = os.path.join(opt.save_dir, opt.id)
    n = 1
    while os.path.exists(save_folder):
        opt.id = f'{opt.id.split("_v_")[0]}_v_{n}'
        save_folder = os.path.join(opt.save_dir, opt.id)
        n += 1
    os.makedirs(save_folder)
    return save_folder


def backup_environment(save_folder: str, repo_root: str):
    """Copy ``cfgs/``, the port's package ``dvc_tpu_torch/`` (without
    ``__pycache__`` and the kernels' ``_build/``) and the top-level ``.py``
    files of ``repo_root`` into ``<save_folder>/backup``, for provenance."""
    backup = os.path.join(save_folder, 'backup')
    os.makedirs(backup, exist_ok=True)
    for name in ('cfgs', 'dvc_tpu_torch'):
        src = os.path.join(repo_root, name)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(backup, name),
                            dirs_exist_ok=True,
                            ignore=shutil.ignore_patterns('__pycache__',
                                                          '_build'))
    for f in os.listdir(repo_root):
        if f.endswith('.py'):
            shutil.copy(os.path.join(repo_root, f), backup)


def create_logger(folder: str, filename: str = 'train.log') -> logging.Logger:
    logger = logging.getLogger('dvc_tpu_torch')
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()
    fmt = logging.Formatter('[%(asctime)s] %(message)s',
                            datefmt='%m-%d %H:%M:%S')
    for handler in (logging.StreamHandler(sys.stdout),
                    logging.FileHandler(os.path.join(folder, filename))):
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    return logger


def quiet_logger() -> logging.Logger:
    """A logger that writes nothing: the data-parallel ranks' other than
    rank 0's, which alone logs and writes the run folder."""
    logger = logging.getLogger('dvc_tpu_torch.quiet')
    logger.handlers.clear()
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger


class MetricsWriter:
    """Scalar metrics of a run (the reference's tensorboardX writer,
    train.py:36,211-213,250-254): ``<folder>/metrics.jsonl``, one
    ``{"tag", "value", "step"}`` line a scalar, always; TensorBoard events
    too where ``tensorboardX`` imports."""

    def __init__(self, folder: str):
        os.makedirs(folder, exist_ok=True)
        self._f = open(os.path.join(folder, 'metrics.jsonl'), 'a')
        try:
            from tensorboardX import SummaryWriter
            self._tb = SummaryWriter(folder)
        except ImportError:
            self._tb = None

    def add_scalar(self, tag: str, value, step: int):
        self._f.write(json.dumps({'tag': tag, 'value': float(value),
                                  'step': int(step)}) + '\n')
        self._f.flush()
        if self._tb:
            self._tb.add_scalar(tag, float(value), step)

    def close(self):
        self._f.close()
        if self._tb:
            self._tb.close()


def print_opt(opt, logger):
    logger.info('|  option  |  value  |')
    for k, v in sorted(opt.to_dict().items()):
        logger.info(f'| {k} | {v} |')
