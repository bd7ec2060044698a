"""The port's U^2-Net (`freefine_tpu_torch.models.u2net`) against the JAX
package: u2netp's saliency at an even and an odd input size (ceil-mode
pooling, non-integer linear upsampling), `get_mask_from_saliency`, the
official key layout (tests/fixtures/u2netp_keys.txt) both ways, and
`load_u2net` on a u2netp-layout .pth against JAX's `load_u2net`.  The
port's random weights and BatchNorm statistics go through
`freefine_tpu.weights.convert_u2net` into flax.

Tolerances: the saliency within 2e-4 of max |ref|; the masks equal but
for at most 0.5 % of the pixels, those whose normalised saliency lies
within 1e-3 of the threshold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu import weights as JW
from freefine_tpu.models.u2net import U2Net as JU2Net
from freefine_tpu.models.u2net import get_mask_from_saliency as j_get_mask
from freefine_tpu.models.u2net import u2netp_config as j_u2netp_config
from freefine_tpu_torch import weights as W
from freefine_tpu_torch.models.u2net import U2Net, get_mask_from_saliency, u2netp_config
from test_torch_depth import assert_close, manifest, np_state
from test_torch_sv3d import _abstract, randomize_all, shapes_template

torch.set_num_threads(2)

MASK_SHARE = 5e-3


@pytest.fixture(scope="module")
def u2netp():
    model = randomize_all(U2Net(u2netp_config()), 6).eval()
    jmodel = JU2Net(j_u2netp_config())
    tmpl = shapes_template(jmodel.init, (1, 64, 64, 3))
    params = JW.convert_u2net(tmpl, np_state(model.state_dict()))
    return model, jmodel, jax.jit(jmodel.apply), params


@pytest.mark.parametrize("hw", [(64, 64), (45, 37)])
def test_u2netp_matches_jax(u2netp, hw):
    model, _, apply, params = u2netp
    x = np.random.default_rng(7).random((1, *hw, 3)).astype(np.float32)
    want = np.asarray(apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == want.shape == (1, *hw)
    assert want.std() > 1e-3
    assert_close(got, want)


def test_get_mask_from_saliency_matches_jax(u2netp):
    model, jmodel, apply, params = u2netp
    img = np.random.default_rng(8).integers(0, 255, (70, 50, 3), dtype=np.uint8)
    jitted = type("Jitted", (), {"apply": staticmethod(apply)})()
    want = j_get_mask(jitted, params, img, size=64)
    got = get_mask_from_saliency(model, img, size=64)
    assert got.shape == want.shape == (70, 50) and got.dtype == np.uint8
    assert 0 < (want > 0).mean() < 1
    assert ((got > 0) != (want > 0)).mean() <= MASK_SHARE


def test_u2netp_layout_both_ways():
    """The official u2netp layout (the fixture, without the BatchNorms'
    num_batches_tracked) is the port's state dict, and the JAX converter
    builds its tree from exactly those tensors."""
    want = manifest("u2netp_keys.txt")
    with torch.device("meta"):
        model = U2Net(u2netp_config())
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    tmpl = shapes_template(JU2Net(j_u2netp_config()).init, (1, 64, 64, 3))
    assert _abstract(JW.convert_u2net, tmpl, want) == set(want)


def test_load_u2net_matches_jax(u2netp, tmp_path):
    model = u2netp[0]
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    path = str(tmp_path / "u2netp.pth")
    torch.save(sd, path)
    loaded = W.load_u2net(U2Net(u2netp_config()), path)
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in model.state_dict().items())
    tmpl = shapes_template(JU2Net(j_u2netp_config()).init, (1, 64, 64, 3))
    tree = JW.load_u2net(tmpl, path)
    back = W.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree), model)
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
    del sd["stage1.rebnconvin.bn_s1.running_mean"]
    torch.save(sd, path)
    with pytest.raises(KeyError, match="running_mean"):
        W.load_u2net(U2Net(u2netp_config()), path)
