"""The port's FID InceptionV3 (`freefine_tpu_torch.models.inception`) against
the JAX package's, at full width (it has no narrow configuration).

  * the forward at batch 2 from a 224^2 input (upsampled to 299 inside
    both models, then the 94 convolutions, the count-excluding average
    pools and Mixed_7c's max pool, the mean pool), the port's random weights
    carried to JAX through `convert_inception_fid` on pytorch-fid's
    layout: within 1e-4 of max |ref|;
  * `load_inception_fid` on a pytorch-fid checkpoint written here (with the
    classifier, the auxiliary head and `num_batches_tracked`, which both
    loaders ignore) fills the model bit for bit, and JAX's converter reads
    the same file into params that `state_dict_from_flax` carries back bit
    for bit; a missing tensor raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu import weights as JW
from freefine_tpu.models.inception import InceptionV3FID as JInception
from freefine_tpu_torch import weights as W
from freefine_tpu_torch.models.inception import InceptionV3FID
from test_torch_depth import jax_template, np_state, randomize

torch.set_num_threads(2)

TOL = 1e-4  # of max |ref|


def random_inception(seed: int) -> InceptionV3FID:
    """Random weights (`randomize`) and running statistics: means N(0, 0.1),
    variances in [0.5, 1.5]."""
    model = randomize(InceptionV3FID(), seed).eval()
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            a = (rng.normal(0, 0.1, buf.shape) if name.endswith("running_mean")
                 else rng.uniform(0.5, 1.5, buf.shape))
            buf.copy_(torch.from_numpy(a.astype(np.float32)))
    return model


def pytorch_fid_layout(model: InceptionV3FID) -> dict:
    """The model's tensors as pytorch-fid's checkpoint holds them: beside
    them the classifier, an auxiliary head's conv and each BatchNorm's
    `num_batches_tracked`."""
    sd = dict(model.state_dict())
    sd["fc.weight"] = torch.zeros(1008, 2048)
    sd["fc.bias"] = torch.zeros(1008)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    for k in list(sd):
        if k.endswith(".bn.running_var"):
            sd[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


@pytest.fixture(scope="module")
def inception():
    model = random_inception(5)
    jmodel = JInception()
    tmpl = jax_template(jmodel, np.zeros((1, 299, 299, 3)))
    params = JW.convert_inception_fid(tmpl, np_state(pytorch_fid_layout(model)))
    return model, jmodel, params


def test_forward_matches_jax(inception):
    model, jmodel, params = inception
    x = np.random.default_rng(3).normal(size=(2, 224, 224, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2048)
    assert np.abs(want).max() > 0 and np.abs(want[0] - want[1]).max() > 0
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


def test_loader_and_carry_across_match_jax(inception, tmp_path):
    model, _, params = inception
    path = str(tmp_path / "pt_inception.pth")
    torch.save(pytorch_fid_layout(model), path)
    loaded = W.load_inception_fid(InceptionV3FID(), path)
    want = model.state_dict()
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, want[k]), k
    back = W.state_dict_from_flax(params, model)
    assert sorted(back) == sorted(want)
    for k, v in back.items():
        assert torch.equal(v, want[k]), k
    sd = pytorch_fid_layout(model)
    del sd["Mixed_6c.branch7x7dbl_3.bn.running_var"]
    torch.save(sd, path)
    with pytest.raises(KeyError, match="Mixed_6c.branch7x7dbl_3.bn.running_var"):
        W.load_inception_fid(InceptionV3FID(), path)
