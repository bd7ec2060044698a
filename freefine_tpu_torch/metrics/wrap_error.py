"""WRAP_E, the warp error (mirrors `freefine_tpu.metrics.wrap_error`): the
mean L1 between the coarse input and the generated image inside the target
mask, per case sum |coarse*m - gen*m| / m.sum() with the mask replicated
over 3 channels, averaged over the cases.  Float64 numpy on the host; the
files are read as stored (`utils.image_io.read_png`, mode None), as
`np.array(Image.open(p))` reads them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from freefine_tpu_torch.utils.image_io import read_png


def wrap_error_single(
    coarse: np.ndarray, generated: np.ndarray, tgt_mask: np.ndarray
) -> float:
    c = np.asarray(coarse, np.float64) / 255.0
    g = np.asarray(generated, np.float64) / 255.0
    m = np.asarray(tgt_mask, np.float64) / 255.0
    if m.ndim == 3:
        m = m[..., 0]
    mask3 = np.repeat(m[..., None], 3, axis=2)
    denom = mask3.sum()
    if denom == 0:
        return 0.0
    return float(np.abs(c * mask3 - g * mask3).sum() / denom)


def wrap_error(data: Dict, image_label: str = "gen_img_path") -> float:
    """Over the merged results JSON (image -> instances -> cases)."""
    total, num = 0.0, 0
    for image in data.values():
        for instance in image["instances"].values():
            for sample in instance.values():
                coarse = read_png(sample["coarse_input_path"])
                gen = read_png(sample[image_label])
                mask = read_png(sample["tgt_mask_path"])
                total += wrap_error_single(coarse, gen, mask)
                num += 1
    return total / max(num, 1)
