"""Preference scores (mirrors `freefine_tpu.metrics.scoring`).

  * HPS: HPSv2.1's OpenCLIP ViT-H-14 cosine of each generated image with
    its image's GPT-4V caption, both features L2-normalised, averaged;
  * IRS: ImageReward-v1.0 (BLIP ViT-L + BERT cross encoder + MLP head,
    `models.blip.ImageReward`) of each generated image under the caption,
    averaged.

The encoders run on their modules' device; the host reads the files and
preprocesses with `metrics.preprocess.clip_image_transform` (OpenAI CLIP's
chain, PIL's resample copied).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from freefine_tpu_torch.metrics.preprocess import clip_image_transform
from freefine_tpu_torch.models.blip import HashWordTokenizer
from freefine_tpu_torch.utils.image_io import read_png


def hps_single(
    img: np.ndarray, prompt: str,
    encode_image: Callable[[np.ndarray], np.ndarray],
    encode_text: Callable[[str], np.ndarray],
) -> float:
    fi = np.asarray(encode_image(img), np.float64)
    ft = np.asarray(encode_text(prompt), np.float64)
    fi = fi / max(np.linalg.norm(fi), 1e-12)
    ft = ft / max(np.linalg.norm(ft), 1e-12)
    return float(fi @ ft)


def _generated(data: Dict, image_label: str):
    """(generated image uint8 RGB, prompt) per case: the image's
    '4v_caption', else the case's own."""
    for image in data.values():
        prompt = image.get("4v_caption", "")
        for instance in image["instances"].values():
            for sample in instance.values():
                yield (read_png(sample[image_label], "RGB"),
                       prompt or sample.get("4v_caption", ""))


def hps(data: Dict, image_label: str, encode_image, encode_text) -> float:
    """Average HPS over the results JSON."""
    vals = [hps_single(img, p, encode_image, encode_text)
            for img, p in _generated(data, image_label)]
    return sum(vals) / max(len(vals), 1)


def make_hps_encoders(image_model, text_model, tokenizer):
    """(encode_image, encode_text) from a `CLIPImageEncoder(clip_vit_h14())`
    and an `OpenCLIPText(open_clip_text_h14())` on their devices, with the
    port's CLIP tokenizer (`models.tokenizer.load_tokenizer`)."""
    dev_i = next(image_model.parameters()).device
    dev_t = next(text_model.parameters()).device

    @torch.no_grad()
    def encode_image(img):
        x = torch.from_numpy(clip_image_transform(img)).to(dev_i)
        return image_model(x)[0].float().cpu().numpy()

    @torch.no_grad()
    def encode_text(prompt):
        ids = torch.as_tensor(np.asarray(tokenizer.encode(prompt)), dtype=torch.long,
                              device=dev_t)[None]
        return text_model(ids)[0].float().cpu().numpy()

    return encode_image, encode_text


def make_irs_scorer(model, tokenizer=None) -> Callable[[np.ndarray, str], float]:
    """score(img, prompt) from an `ImageReward` on its device; the hash
    tokenizer unless a WordPiece one is given."""
    tok = tokenizer or HashWordTokenizer()
    device = next(model.parameters()).device

    @torch.no_grad()
    def score(img: np.ndarray, prompt: str) -> float:
        x = torch.from_numpy(clip_image_transform(img)).to(device)
        ids, mask = (torch.as_tensor(a, dtype=torch.long, device=device)[None]
                     for a in tok.encode(prompt))
        return float(model(x, ids, mask)[0])

    return score


def irs(data: Dict, image_label: str, score) -> float:
    """Average ImageReward over the results JSON: per top-level image its
    GPT-4V caption scores every generated case."""
    vals = [score(img, p) for img, p in _generated(data, image_label)]
    return sum(vals) / max(len(vals), 1)
