"""The port's weight bridge: ``from_jax_params`` (pure numpy) equals the JAX
package's ``export_fusion`` key by key and value by value, and the port's
FusionPDVC loads the result with ``strict=True`` — per-layer prediction
heads and the aliased shared ones alike."""
import numpy as np
import pytest
import torch

from torch_port import fusion_batch, jax_fusion_params, tiny_opt  # noqa: I100

from dvc_tpu.models.pdvc_converter import export_fusion
from dvc_tpu_torch.models import from_jax_params, make_fusion_model

pytestmark = pytest.mark.heavy


@pytest.mark.parametrize('refine', [True, False])
def test_from_jax_params_matches_export_fusion(refine):
    """with_box_refine=0 shares one class/count/box head across layers."""
    opt = tiny_opt(with_box_refine=refine)
    params = jax_fusion_params(opt, fusion_batch(0))
    want = export_fusion(params)
    got = from_jax_params(params)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    model = make_fusion_model(opt, device='cpu')
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in got.items()}, strict=True)
    loaded = model.state_dict()
    assert sorted(loaded) == sorted(got)
    for k, v in loaded.items():
        np.testing.assert_array_equal(v.numpy(), got[k], err_msg=k)
