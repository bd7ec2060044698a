"""The port's BLIP ImageReward (`models.blip`) and pooled OpenCLIP text tower
(`models.open_clip_text.OpenCLIPText`) against the JAX package's, on tiny
configurations with the port's random weights carried to JAX through the
JAX converters on the reference checkpoints' layouts; and the HPS, DINO-v1
and BLIP loaders against the JAX converters.

  * ImageReward scores (ViT, BERT self-attention under the padding's key
    mask, cross-attention to the image tokens, the MLP head, the released
    normalisation) within 1e-4 of max |ref|, under the hash tokenizer's ids
    and under a WordPiece vocabulary's; the ids of both tokenizers equal
    JAX's;
  * OpenCLIPText's pooled features (argmax(ids) pooling: under the hash
    tokenizer the largest hashed word, since its EOT id is 1) within 1e-4 of
    max |ref|, the tokenizer's ids equal JAX's;
  * `state_dict_from_flax` carries ImageReward's and OpenCLIPText's JAX
    trees back bit for bit;
  * `load_hps` (open_clip ViT-H-14's layout: the image tower under
    `visual.`, the text tower's fused in_proj), `load_dino_v1` (torchhub's
    layout without LayerScale) and `load_blip_image_reward` (ImageReward's,
    with tensors the scorer never reads) fill the port's modules with what
    the JAX converters read from the same files, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu import weights as JW
from freefine_tpu.models import blip as JB
from freefine_tpu.models.clip_image import CLIPImageEncoder as JCLIPImage
from freefine_tpu.models.clip_image import CLIPVisionConfig as JCLIPVisionConfig
from freefine_tpu.models.dinov2 import DINOv2 as JDINOv2
from freefine_tpu.models.dinov2 import DINOv2Config as JDINOv2Config
from freefine_tpu.models.open_clip_text import OpenCLIPText as JOpenCLIPText
from freefine_tpu.models.open_clip_text import OpenCLIPTextConfig as JOpenCLIPTextConfig
from freefine_tpu.models.tokenizer import HashTokenizer as JHashTokenizer
from freefine_tpu_torch import weights as W
from freefine_tpu_torch.config import OpenCLIPTextConfig
from freefine_tpu_torch.models import blip as B
from freefine_tpu_torch.models.clip_image import CLIPImageEncoder, CLIPVisionConfig
from freefine_tpu_torch.models.dinov2 import DINOv2, DINOv2Config
from freefine_tpu_torch.models.open_clip_text import OpenCLIPText
from freefine_tpu_torch.models.tokenizer import HashTokenizer
from test_torch_depth import jax_template, np_state, randomize
from test_torch_weights import cached_shapes

torch.set_num_threads(2)

TOL = 1e-4  # of max |ref|
BLIP = dict(image_size=32, patch_size=16, vision_width=32, vision_layers=2, vision_heads=2,
            text_width=32, text_layers=2, text_heads=2, text_intermediate=64, vocab_size=300)
TEXT = dict(vocab_size=1000, width=32, heads=2, layers=2, projection_dim=16)
VISION = dict(image_size=32, patch_size=16, hidden_size=32, intermediate_size=64, num_layers=2,
              num_heads=2, projection_dim=16, activation="gelu")
DINO_V1 = dict(dim=32, depth=2, heads=2, patch_size=16, pos_embed_size=2)
PROMPTS = ["a red cup moved to the left", "two dogs, one cat; a slightly rotated chair"]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(want).max() > 0
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


def _same_state(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k


# -- ImageReward -----------------------------------------------------------------


@pytest.fixture(scope="module")
def image_reward():
    model = randomize(B.ImageReward(B.BlipConfig(**BLIP)), 3).eval()
    jmodel = JB.ImageReward(JB.BlipConfig(**BLIP))
    tmpl = cached_blip_template(jmodel)
    params = JW.convert_blip_image_reward(tmpl, np_state(model.state_dict()))
    return model, jmodel, params


def int_template(jmodel, *specs):
    """`jax_template` with inputs of their own dtypes: (shape, dtype) each."""
    return cached_shapes(type(jmodel).__name__, (repr(jmodel), specs), lambda: jax.eval_shape(
        jmodel.init, jax.random.key(0), *(jax.ShapeDtypeStruct(s, d) for s, d in specs)))


def cached_blip_template(jmodel):
    c = jmodel.config
    s = (1, c.max_text_len)
    return int_template(jmodel, ((1, c.image_size, c.image_size, 3), jnp.float32),
                        (s, jnp.int32), (s, jnp.int32))


def _vocab(tmp_path):
    words = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]"]
    words += ["a", "red", "cup", "moved", "to", "the", "left", "two", "dog", "##s", ",", "one",
              "cat", ";", "slight", "##ly", "rot", "##ated", "chair"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(words) + "\n")
    return str(path)


@pytest.mark.parametrize("tokenizer", ["hash", "wordpiece"])
def test_image_reward_matches_jax(image_reward, tmp_path, tokenizer):
    model, jmodel, params = image_reward
    if tokenizer == "hash":
        tok, jtok = B.HashWordTokenizer(300), JB.HashWordTokenizer(300)
    else:
        vocab = _vocab(tmp_path)
        tok, jtok = (m.WordPieceTokenizer.from_vocab_file(vocab) for m in (B, JB))
    enc = [tok.encode(p) for p in PROMPTS]
    for (ids, mask), p in zip(enc, PROMPTS):
        jids, jmask = jtok.encode(p)
        assert np.array_equal(ids, jids) and np.array_equal(mask, jmask)
        assert mask.sum() < mask.size  # padded keys in every row
    ids = np.stack([e[0] for e in enc])
    mask = np.stack([e[1] for e in enc])
    images = np.random.default_rng(4).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(images), jnp.asarray(ids),
                                 jnp.asarray(mask))
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(ids).long(),
                    torch.from_numpy(mask).long())
    assert got.dtype == torch.float32
    _close(got.numpy(), want)
    assert abs(float(want[0]) - float(want[1])) > 0


def test_image_reward_carries_back_from_jax(image_reward):
    model, _, params = image_reward
    _same_state(W.state_dict_from_flax(params, model), model.state_dict())


def test_blip_loader_matches_jax_converter(image_reward, tmp_path):
    model, jmodel, _ = image_reward
    sd = dict(model.state_dict())
    # ImageReward.pt's tensors the scorer never reads
    sd["blip.text_encoder.embeddings.position_ids"] = torch.arange(512)[None]
    sd["blip.text_proj.weight"] = torch.zeros(16, 32)
    path = str(tmp_path / "ImageReward.pt")
    torch.save(sd, path)
    raw = torch.load(path, weights_only=True)
    jparams = JW.convert_blip_image_reward(cached_blip_template(jmodel),
                                           {k: v.numpy() for k, v in raw.items()})
    loaded = W.load_blip_image_reward(B.ImageReward(B.BlipConfig(**BLIP)), path)
    _same_state(loaded.state_dict(), W.state_dict_from_flax(jparams, loaded))
    _same_state(loaded.state_dict(), model.state_dict())


# -- OpenCLIP text -----------------------------------------------------------------


@torch.no_grad()
def open_clip_layout(text: OpenCLIPText, image: CLIPImageEncoder = None) -> dict:
    """The towers' tensors as open_clip's ViT-H-14 state dict holds them:
    the text tower at the top level (q, k, v fused into `attn.in_proj_*`,
    `text_projection` [width, proj]), the image tower under `visual.`."""
    sd = text.state_dict()
    pre = "text_model."
    out = {"token_embedding.weight": sd[f"{pre}embeddings.token_embedding.weight"],
           "positional_embedding": sd[f"{pre}embeddings.position_embedding.weight"],
           "text_projection": sd["text_projection.weight"].t().contiguous(),
           "ln_final.weight": sd[f"{pre}final_layer_norm.weight"],
           "ln_final.bias": sd[f"{pre}final_layer_norm.bias"], "logit_scale": torch.ones(())}
    for i in range(text.config.layers):
        src, dst = f"{pre}encoder.layers.{i}.", f"transformer.resblocks.{i}."
        for leaf in ("weight", "bias"):
            out[f"{dst}attn.in_proj_{leaf}"] = torch.cat(
                [sd[f"{src}self_attn.{p}_proj.{leaf}"] for p in "qkv"])
            for a, b in (("self_attn.out_proj", "attn.out_proj"), ("layer_norm1", "ln_1"),
                         ("layer_norm2", "ln_2"), ("mlp.fc1", "mlp.c_fc"),
                         ("mlp.fc2", "mlp.c_proj")):
                out[f"{dst}{b}.{leaf}"] = sd[f"{src}{a}.{leaf}"]
    if image is not None:
        out.update((f"visual.{k}", v) for k, v in image.state_dict().items())
    return out


@pytest.fixture(scope="module")
def open_clip_text():
    model = randomize(OpenCLIPText(OpenCLIPTextConfig(**TEXT)), 5).eval()
    jmodel = JOpenCLIPText(JOpenCLIPTextConfig(**TEXT))
    tmpl = int_template(jmodel, ((1, 77), jnp.int32))
    params = JW.convert_open_clip_text(tmpl, np_state(open_clip_layout(model)), prefix="")
    return model, jmodel, params


def test_open_clip_text_pooled_matches_jax(open_clip_text):
    model, jmodel, params = open_clip_text
    tok, jtok = HashTokenizer(TEXT["vocab_size"]), JHashTokenizer(TEXT["vocab_size"])
    ids = np.stack([tok.encode(p) for p in PROMPTS])
    assert np.array_equal(ids, np.stack([jtok.encode(p) for p in PROMPTS]))
    # the hash tokenizer's EOT id is 1: argmax pools at the largest word id
    assert (ids.argmax(-1) != np.argmax(ids == 1, -1)).all()
    want = jax.jit(jmodel.apply)(params, jnp.asarray(ids))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
    _close(got.numpy(), want)


def test_open_clip_text_carries_back_from_jax(open_clip_text):
    model, _, params = open_clip_text
    _same_state(W.state_dict_from_flax(params, model), model.state_dict())


def test_hps_loader_matches_jax(open_clip_text, tmp_path):
    text, jtext, _ = open_clip_text
    image = randomize(CLIPImageEncoder(CLIPVisionConfig(**VISION)), 6)
    jimage = JCLIPImage(JCLIPVisionConfig(**VISION))
    path = str(tmp_path / "HPS_v2.1.pt")
    torch.save({"state_dict": open_clip_layout(text, image)}, path)
    ti = jax_template(jimage, np.zeros((1, 32, 32, 3)))
    tt = int_template(jtext, ((1, 77), jnp.int32))
    jp_image, jp_text = JW.load_hps(ti, tt, path)
    got_i, got_t = W.load_hps(CLIPImageEncoder(CLIPVisionConfig(**VISION)),
                              OpenCLIPText(OpenCLIPTextConfig(**TEXT)), path)
    _same_state(got_i.state_dict(), W.state_dict_from_flax(jp_image, got_i))
    _same_state(got_t.state_dict(), W.state_dict_from_flax(jp_text, got_t))
    _same_state(got_i.state_dict(), image.state_dict())
    _same_state(got_t.state_dict(), text.state_dict())


def test_dino_v1_loader_matches_jax(tmp_path):
    model = randomize(DINOv2(DINOv2Config(**DINO_V1)), 7)
    sd = {k: v for k, v in model.state_dict().items() if ".ls" not in k}  # DINO-v1: no LayerScale
    path = str(tmp_path / "dino_vitb16_pretrain.pth")
    torch.save(sd, path)
    jmodel = JDINOv2(JDINOv2Config(**DINO_V1))
    jparams = JW.load_dino_v1(jax_template(jmodel, np.zeros((1, 32, 32, 3))), path)
    got = W.load_dino_v1(DINOv2(DINOv2Config(**DINO_V1)), path)
    _same_state(got.state_dict(), W.state_dict_from_flax(jparams, got))
    gammas = [v for k, v in got.state_dict().items() if ".ls" in k]
    assert len(gammas) == 2 * DINO_V1["depth"] and all(bool((g == 1).all()) for g in gammas)
