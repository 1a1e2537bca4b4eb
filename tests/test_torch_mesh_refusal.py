"""``--tpu_mesh_data`` > 1 (the JAX Trainer's data mesh) is refused by the
port's PDVC training drivers, which train in one process:
``refuse_data_mesh`` raises ``NotImplementedError`` naming ROADMAP.md A6,
so ``new_train`` and ``run_train`` stop rather than train a two-way run on
one process.  ``run_eval`` of such a run still evaluates
(``tests/test_torch_eval_loop.py``)."""
import pytest

from dvc_tpu_torch.new_train import main as new_train_main
from dvc_tpu_torch.run_train import main as run_train_main
from dvc_tpu_torch.utils.config import parse_opts
from test_torch_run_train import write_recipe
from test_torch_train import REPO, _synthetic_recipe


def test_new_train_refuses_a_data_mesh(tmp_path):
    opt = parse_opts(['--cfg_path', _synthetic_recipe(tmp_path), '--debug',
                      '--device', 'cpu', '--tpu_mesh_data', '2'], root=REPO)
    assert opt.tpu_mesh_data == 2
    with pytest.raises(NotImplementedError, match='A6'):
        new_train_main(opt)


def test_run_train_refuses_a_data_mesh(tmp_path):
    opt = parse_opts(['--cfg_path', write_recipe(tmp_path, 'standard'),
                      '--debug', '--device', 'cpu', '--tpu_mesh_data', '2'],
                     root=REPO)
    assert opt.tpu_mesh_data == 2
    with pytest.raises(NotImplementedError, match='A6'):
        run_train_main(opt)
