"""``--tpu_mesh_data 2`` (the JAX Trainer's data mesh) trains: the port's
PDVC drivers ``new_train`` and ``run_train`` run as two gloo ranks of a
CPU process group (one made by the test, as ``torchrun`` makes one, and
the ranks that ``new_train`` spawns itself), rank 0 alone writing the run
folder and validating; the ranks end on the same weights, those of
``model-last.pth``, and the validation records are those of a one-process
validation of them.  ``run_eval`` of such a run evaluates
(``tests/test_torch_eval_loop.py``); the data-parallel step against the
JAX mesh is tests/test_torch_data_parallel.py."""
import json
import os

import numpy as np
import pytest
import torch

from test_torch_run_train import write_recipe  # noqa: I100
from test_torch_train import REPO, _synthetic_recipe
from torch_mesh_workers import assert_equal_states, pdvc_driver, spawn

from dvc_tpu_torch.data import (BatchLoader, DenseCaptionDataset,
                                FusionBatchLoader, FusionDataset)
from dvc_tpu_torch.eval import evaluate
from dvc_tpu_torch.models import make_pdvc_model
from dvc_tpu_torch.new_train import main as new_train_main
from dvc_tpu_torch.train import Trainer, load_checkpoint
from dvc_tpu_torch.utils.config import parse_opts

pytestmark = pytest.mark.heavy

FUSION_RUN = ['epoch1.json', 'epoch1.json_rerank_alpha1.0_temp2.0.json',
              'info.json', 'model-last.pth', 'train.log']


def _driver_run(tmp_path, name, recipe):
    """``name``'s driver on two ranks (a group made by the test) with
    ``--debug --device cpu --tpu_mesh_data 2``: checks that rank 0 alone
    wrote one run folder, that the ranks end on the same weights (those of
    model-last.pth), and that its validation records are those of a
    one-process validation of model-last.pth."""
    opt = parse_opts(['--cfg_path', recipe, '--debug', '--device', 'cpu',
                      '--tpu_mesh_data', '2'], root=REPO)
    ranks = spawn(pdvc_driver, 2, tmp_path / 'ranks', name, opt)
    (folder, losses, state), (folder1, losses1, state1) = ranks
    assert folder1 == folder and losses1 == losses
    assert all(np.isfinite(v) for v in losses.values())
    assert os.listdir(opt.save_dir) == [os.path.basename(folder)]
    assert_equal_states(state, state1)
    ck = load_checkpoint(os.path.join(folder, 'model-last.pth'))
    assert_equal_states(ck['model'], state)
    with open(os.path.join(folder, 'train.log')) as f:
        log = f.read()
    assert log.count('epoch 0:') == 1 and log.count('Training done') == 1
    return opt, folder, state


def _one_process_validation(opt, folder, state, dataset, loader, tmp_path):
    """The records of a one-process validation of ``state`` against the
    run's epoch1.json (one thread, as a rank)."""
    trainer = Trainer(opt, device='cpu', model=(
        make_pdvc_model(opt, 'cpu', seed=0) if dataset is DenseCaptionDataset
        else None))
    trainer.model.load_state_dict(state, strict=True)
    ds = dataset(opt.val_caption_file, opt.visual_feature_folder,
                 opt.dict_file, opt, **({'seed': opt.seed} if dataset is
                                        DenseCaptionDataset else {}))
    path = str(tmp_path / 'one.json')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        evaluate(trainer, loader(ds, opt.batch_size_for_eval, False, opt),
                 path, alpha=opt.ec_alpha,
                 dvc_eval_version=opt.eval_tool_version, debug=opt.debug)
    except FileNotFoundError:
        pass                    # the metrics' gt files: the records stand
    finally:
        torch.set_num_threads(threads)
    with open(path) as f, open(os.path.join(folder, 'epoch1.json')) as g:
        assert json.load(f)['results'] == json.load(g)['results']


def test_new_train_trains_on_a_data_mesh(tmp_path):
    recipe = _synthetic_recipe(tmp_path, n_videos=9)
    opt, folder, state = _driver_run(tmp_path, 'new_train', recipe)
    assert sorted(os.listdir(folder)) == FUSION_RUN
    _one_process_validation(opt, folder, state, FusionDataset,
                            FusionBatchLoader, tmp_path)


def test_run_train_trains_on_a_data_mesh(tmp_path):
    recipe = write_recipe(tmp_path, 'standard')
    opt, folder, state = _driver_run(tmp_path, 'run_train', recipe)
    assert {'epoch1.json', 'model-best.pth', 'model-last.pth', 'info.json',
            'train.log', 'metrics.jsonl', 'backup'} <= set(os.listdir(folder))
    with open(os.path.join(folder, 'metrics.jsonl')) as f:
        tags = [json.loads(line)['tag'] for line in f]
    assert tags.count('lr') == 1
    _one_process_validation(opt, folder, state, DenseCaptionDataset,
                            BatchLoader, tmp_path)


def test_new_train_spawns_its_ranks(tmp_path, monkeypatch):
    """Without a group, ``new_train.main`` with ``--tpu_mesh_data 2`` spawns
    the two ranks itself (``parallel.run``) and returns rank 0's run
    folder and losses: the one-process run's, to float rounding."""
    monkeypatch.setenv('OMP_NUM_THREADS', '1')      # the ranks' threads
    recipe = _synthetic_recipe(tmp_path, n_videos=9)
    runs = {}
    for n in (2, 1):
        opt = parse_opts(['--cfg_path', recipe, '--debug', '--device', 'cpu',
                          '--tpu_mesh_data', str(n)], root=REPO)
        opt.id = f'ranks{n}'
        opt.transformer_dropout_prob = opt.drop_prob = 0.0
        runs[n] = new_train_main(opt)
    (folder, losses), (folder1, losses1) = runs[2], runs[1]
    assert os.path.basename(folder) == 'ranks2'
    assert sorted(os.listdir(folder)) == FUSION_RUN
    assert list(losses) == list(losses1)
    for k, v in losses1.items():
        np.testing.assert_allclose(losses[k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
