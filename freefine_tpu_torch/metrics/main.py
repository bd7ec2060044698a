"""GeoBench's metrics CLI (mirrors `freefine_tpu.metrics.main`):

  python -m freefine_tpu_torch.metrics.main --path results.json \\
      --weights-dir WEIGHTS [--fid_path REAL_DIR] [--task 100111111] [--device cuda]

The task string (9 characters, 1 computes): FID, IRS, HPS, BGC, SUBC,
WRAP_E, MD, FID_DINO, FID_KD, in the reference's order and meaning, with
its --level filter, --no_rotate, the --3d mask-key swap and the relative
path fix-up.

`--weights-dir` holds the encoders as `.safetensors` files in the port's
layout (`weights.write_safetensors` of each module's state dict), under the
JAX package's base names: inception_fid, image_reward, hps_image, hps_text,
clip_b32, dino_vitb16, dinov2_vitb14; HPS also reads the CLIP tokenizer's
vocabulary from it when present (else the hash tokenizer).  A metric whose
file is missing prints "unavailable" and gives None, so WRAP_E (and any
subset) always runs.  MD is unavailable: its SIFT keypoints need cv2.
Images are PNGs, read by `utils.image_io.read_png` (no PIL).  The encoders
run on `--device` ("cuda" by default; "cpu" for a run without a card).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import os.path as osp

import torch

ENCODER_FILES = ("inception_fid", "image_reward", "hps_image", "hps_text", "clip_b32",
                 "dino_vitb16", "dinov2_vitb14")


def parse_data_rotate(data):
    """Drop the cases with a z-rotation."""
    for da in data.values():
        for ins in da["instances"].values():
            for case_id in [c for c, gt in ins.items()
                            if gt.get("edit_param", [0] * 6)[5] != 0]:
                ins.pop(case_id)
    return data


def parse_data_3d(data):
    """The 3D evaluation's mask and coarse-input keys."""
    for da in data.values():
        for ins in da["instances"].values():
            for gt in ins.values():
                gt["tgt_mask_path"] = gt["target_mask_0"]
                gt["coarse_input_path"] = gt["coarse_input_path_0"]
    return data


def make_absolute_path(data, base_dir, gen_img_key):
    keys = ["ori_img_path", "coarse_input_path", "ori_mask_path", "tgt_mask_path", gen_img_key]
    for da in data.values():
        for ins in da["instances"].values():
            for gt in ins.values():
                for k in keys:
                    if k in gt:
                        gt[k] = osp.join(base_dir, gt[k])
    return data


def _collect_paths(data, image_label):
    return [gt[image_label] for da in data.values() for ins in da["instances"].values()
            for gt in ins.values()]


def _real_paths(fid_path):
    if not fid_path:
        raise ValueError("--fid_path (the real-image folder) is required for the FID family")
    return [osp.join(fid_path, f) for f in sorted(os.listdir(fid_path))
            if f.lower().endswith((".png", ".jpg", ".jpeg"))]


def build_encoder(name: str, device):
    """The module of `ENCODER_FILES` entry `name` at its published width,
    built on `device` (weights not loaded; on "meta", none allocated)."""
    from freefine_tpu_torch.metrics.consistency import dino_vitb16_config
    from freefine_tpu_torch.models.blip import BlipConfig, ImageReward
    from freefine_tpu_torch.models.clip_image import (
        CLIPImageEncoder,
        clip_vit_b32,
        clip_vit_h14,
    )
    from freefine_tpu_torch.models.dinov2 import DINOv2, dinov2_vitb14
    from freefine_tpu_torch.models.inception import InceptionV3FID
    from freefine_tpu_torch.models.open_clip_text import OpenCLIPText, open_clip_text_h14

    make = {"inception_fid": lambda: InceptionV3FID(device=device),
            "image_reward": lambda: ImageReward(BlipConfig(), device=device),
            "hps_image": lambda: CLIPImageEncoder(clip_vit_h14(), device=device),
            "hps_text": lambda: OpenCLIPText(open_clip_text_h14(), device=device),
            "clip_b32": lambda: CLIPImageEncoder(clip_vit_b32(), device=device),
            "dino_vitb16": lambda: DINOv2(dino_vitb16_config(), device=device),
            "dinov2_vitb14": lambda: DINOv2(dinov2_vitb14(), device=device)}
    return make[name]().eval()


def main(argv=None, timer=None):
    """Parse `argv`, compute the tasks, print and return {metric: value}.
    With a `utils.profiling.StageTimer`, each metric's computation (its
    encoders' loading included) is one stage, the device synchronised at
    its end."""
    parser = argparse.ArgumentParser(description="GeoBench evaluation")
    parser.add_argument("--path", required=True)
    parser.add_argument("--level", default=0, type=int)
    parser.add_argument("--task", default="100111111", type=str)
    parser.add_argument("--gen_img_key", default="gen_img_path")
    parser.add_argument("--no_rotate", action="store_true")
    parser.add_argument("--3d", dest="three_d", action="store_true")
    parser.add_argument("--fid_path", default=None, help="real-image dir for the FID family")
    parser.add_argument("--use_relative_path", action="store_true")
    parser.add_argument("--base_dir", default=None)
    parser.add_argument("--weights-dir", default=None,
                        help="dir of the encoders' .safetensors files (inception_fid, "
                             "image_reward, hps_image, hps_text, clip_b32, dino_vitb16, "
                             "dinov2_vitb14)")
    parser.add_argument("--sd-params", default=None, help="MD (not ported: needs cv2's SIFT)")
    parser.add_argument("--sd-config", default="sd21", choices=["sd21", "sd15", "tiny"],
                        help="MD (not ported)")
    parser.add_argument("--md-corr-dir", default=None, help="MD (not ported)")
    parser.add_argument("--device", default="cuda",
                        help="where the encoders run (default cuda; cpu without a card)")
    args = parser.parse_args(argv)

    from freefine_tpu_torch.data.geobench import filter_by_level
    from freefine_tpu_torch.utils.profiling import synced_stage
    from freefine_tpu_torch.weights import read_safetensors

    with open(args.path) as f:
        data = json.load(f)
    if args.level:
        data = filter_by_level(data, args.level)
    if args.no_rotate:
        data = parse_data_rotate(data)
    if args.three_d:
        data = parse_data_3d(data)
    if args.use_relative_path:
        if not args.base_dir:
            raise ValueError("--base_dir is required with --use_relative_path")
        data = make_absolute_path(data, args.base_dir, args.gen_img_key)

    device = torch.device(args.device)
    label = args.gen_img_key
    result = {}

    def weights_file(name):
        if args.weights_dir is None:
            return None
        p = osp.join(args.weights_dir, f"{name}.safetensors")
        return p if osp.exists(p) else None

    def encoders(*names):
        """The named encoders on the device, or None if a file is missing."""
        files = [weights_file(n) for n in names]
        if None in files:
            return None
        mods = []
        for n, p in zip(names, files):
            # storage left uninitialised, then filled from the file: no
            # random initialisation of weights that the file replaces
            m = build_encoder(n, "meta").to_empty(device=device)
            m.load_state_dict(read_safetensors(p))
            mods.append(m)
        return mods

    def release():
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    def unavailable(metric, need):
        print(f"{metric}: unavailable (missing {need}; pass --weights-dir)")
        result[metric] = None

    task = args.task
    if int(task[0]):
        with synced_stage(timer, "FID", device):
            mods = encoders("inception_fid")
            if mods is None:
                unavailable("FID", "inception_fid.safetensors")
            else:
                from freefine_tpu_torch.metrics.fid import fid_inception

                result["FID"] = fid_inception(_collect_paths(data, label),
                                              _real_paths(args.fid_path), mods[0])
            del mods
            release()
    if int(task[1]):
        with synced_stage(timer, "IRS", device):
            mods = encoders("image_reward")
            if mods is None:
                unavailable("IRS", "image_reward.safetensors")
            else:
                from freefine_tpu_torch.metrics.scoring import irs, make_irs_scorer

                result["IRS"] = irs(data, label, make_irs_scorer(mods[0]))
            del mods
            release()
    if int(task[2]):
        with synced_stage(timer, "HPS", device):
            mods = encoders("hps_image", "hps_text")
            if mods is None:
                unavailable("HPS", "hps_image.safetensors + hps_text.safetensors")
            else:
                from freefine_tpu_torch.metrics.scoring import hps, make_hps_encoders
                from freefine_tpu_torch.models.tokenizer import load_tokenizer

                enc_i, enc_t = make_hps_encoders(*mods, load_tokenizer(args.weights_dir))
                result["HPS"] = hps(data, label, enc_i, enc_t)
            del mods
            release()
    if int(task[3]):
        with synced_stage(timer, "BGC", device):
            mods = encoders("clip_b32")
            if mods is None:
                unavailable("BGC", "clip_b32.safetensors")
            else:
                from freefine_tpu_torch.metrics.consistency import (
                    background_consistency,
                    make_clip_encoder,
                )

                result["BGC"] = background_consistency(data, label, make_clip_encoder(mods[0]))
            del mods
            release()
    if int(task[4]):
        with synced_stage(timer, "SUBC", device):
            mods = encoders("dino_vitb16")
            if mods is None:
                unavailable("SUBC", "dino_vitb16.safetensors")
            else:
                from freefine_tpu_torch.metrics.consistency import (
                    make_dino_encoder,
                    subject_consistency,
                )

                result["SUBC"] = subject_consistency(data, label, make_dino_encoder(mods[0]))
            del mods
            release()
    if int(task[5]):
        from freefine_tpu_torch.metrics.wrap_error import wrap_error

        with synced_stage(timer, "WRAP_E", device):
            result["WRAP_E"] = wrap_error(data, label)
    if int(task[6]):
        print("MD: unavailable (its SIFT keypoints need cv2, which the port does not use; "
              "not ported)")
        result["MD"] = None
    if int(task[7]) or int(task[8]):
        with synced_stage(timer, "FID_DINO+FID_KD", device):
            mods = encoders("dinov2_vitb14")
            if mods is None:
                for i, metric in ((7, "FID_DINO"), (8, "FID_KD")):
                    if int(task[i]):
                        unavailable(metric, "dinov2_vitb14.safetensors")
            else:
                from freefine_tpu_torch.metrics.common import (
                    fid_from_features,
                    polynomial_mmd,
                )
                from freefine_tpu_torch.metrics.consistency import make_dino_batch_encoder
                from freefine_tpu_torch.metrics.fid import batched_features

                enc_b, prep = make_dino_batch_encoder(mods[0])
                real = _real_paths(args.fid_path)
                feats_g = batched_features(_collect_paths(data, label), enc_b, prep)
                feats_r = batched_features(real, enc_b, prep)
                if int(task[7]):
                    result["FID_DINO"] = fid_from_features(feats_g, feats_r)
                if int(task[8]):
                    result["FID_KD"] = polynomial_mmd(feats_g, feats_r)
            del mods
            release()

    print("-----Result-----")
    for k, v in result.items():
        print(f"{k}: {v}")
    return result


if __name__ == "__main__":
    main()
