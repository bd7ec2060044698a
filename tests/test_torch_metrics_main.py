"""`metrics.main` of the port against the JAX package's, end to end, on the
results set of `test_torch_metrics.py` (two images, two cases each, PNGs
written by PIL) and its real-image folder: JAX's main reading msgpack
params, the port's reading safetensors files of the same weights, at full
width as both mains build their encoders (InceptionV3 for FID, CLIP
ViT-B/32 for BGC).

Held: FID within 1e-3 relative (four generated images: the covariances are
singular), BGC within 1e-5, WRAP_E within 1e-12; IRS, HPS, SUBC, FID_DINO
and FID_KD unavailable on both sides (no files: their encoders and metric
functions are held on tiny configurations in `test_torch_metrics.py` and
`test_torch_blip_openclip.py`), MD unavailable in both.
"""

import os

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from freefine_tpu import weights as JW
from freefine_tpu.metrics import main as JMAIN
from freefine_tpu.models.clip_image import CLIPImageEncoder as JCLIPImage
from freefine_tpu.models.clip_image import clip_vit_b32 as j_clip_vit_b32
from freefine_tpu.models.inception import InceptionV3FID as JInception
from freefine_tpu_torch.metrics import main as MAIN
from freefine_tpu_torch.models.clip_image import CLIPImageEncoder, clip_vit_b32
from freefine_tpu_torch.weights import random_weights, write_safetensors
from test_torch_depth import jax_template, np_state
from test_torch_inception import pytorch_fid_layout, random_inception
from test_torch_metrics import write_real, write_results

torch.set_num_threads(2)


def _write_weights(wdir):
    """Full-width InceptionV3 and CLIP ViT-B/32 with random weights: msgpack
    of JAX's converted params and the port's safetensors.  The ViT takes the
    bench's scheme (`random_weights`, N(0, 0.02)): `randomize`'s
    N(0, 1 / fan_in) and N(0, 0.5) tables make 12 layers of 768 chaotic,
    float32 rounding moving its features by order 1."""
    os.makedirs(wdir, exist_ok=True)
    inception = random_inception(21)
    clip = random_weights(CLIPImageEncoder(clip_vit_b32()), 22)
    jax_side = {
        "inception_fid": JW.convert_inception_fid(
            jax_template(JInception(), np.zeros((1, 299, 299, 3))),
            np_state(pytorch_fid_layout(inception))),
        "clip_b32": JW.convert_open_clip_vision(
            jax_template(JCLIPImage(j_clip_vit_b32()), np.zeros((1, 224, 224, 3))),
            np_state({f"visual.{k}": v for k, v in clip.state_dict().items()})),
    }
    for name, module in (("inception_fid", inception), ("clip_b32", clip)):
        write_safetensors(module.state_dict(), os.path.join(wdir, f"{name}.safetensors"))
        with open(os.path.join(wdir, f"{name}.msgpack"), "wb") as f:
            f.write(flax.serialization.msgpack_serialize(jax.tree.map(np.asarray,
                                                                      jax_side[name])))


def test_main_end_to_end_matches_jax(tmp_path, capsys):
    path, _ = write_results(str(tmp_path))
    real = write_real(str(tmp_path / "real"))
    wdir = str(tmp_path / "weights")
    _write_weights(wdir)
    argv = ["--path", path, "--task", "111111111", "--fid_path", real, "--weights-dir", wdir]
    want = JMAIN.main(argv)
    got = MAIN.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert list(got) == list(want)
    for metric in ("IRS", "HPS", "SUBC", "FID_DINO", "FID_KD", "MD"):
        assert got[metric] is None and want[metric] is None, metric
    assert "MD: unavailable" in out and "SUBC: unavailable" in out
    assert abs(got["FID"] - want["FID"]) <= 1e-3 * abs(want["FID"]), (got["FID"], want["FID"])
    assert abs(got["BGC"] - want["BGC"]) <= 1e-5, (got["BGC"], want["BGC"])
    assert abs(got["WRAP_E"] - want["WRAP_E"]) <= 1e-12
