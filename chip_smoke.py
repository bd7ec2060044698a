#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`freefine_tpu_torch`) on one
NVIDIA H100.

    python3 chip_smoke.py            # all phases, one card

Every phase that runs the models names its GroupNorm route
(FREEFINE_FUSED_GN "0" or "1"), except the checks of the default ("auto"):
phase 3's and phase 9b's.

The timed phases run one warm-up and `--timed-runs` timed edits or calls
each, 1 by default (2 until the script outgrew its time); where a phase
below says "two timed edits" or "0, 1, 1, 0", that is --timed-runs 2, and
the default runs one edit, or the pair 0, 1.

Phases (any failure raises and exits non-zero; nothing is caught):
  1. print the card's name and power limit; build the CUDA kernels from
     `freefine_tpu_torch/csrc` (one nvcc per source, in parallel) and print
     each instantiation's registers, stack and spills (a spill in a wgmma
     or `gn::` instantiation fails), the backward kernels' shared memory,
     and for each `gn::` instantiation the routes, cluster sizes and shared
     memory of its plans at the GroupNorm shapes;
  2. hold each kernel against its plain PyTorch twin on the card at every
     shape of the SD-1.5 512^2 paths (bf16, and f32 at the VAE shape) and
     of the SDXL 1024^2 edit of phase G-XL (heads of 64: `flash_sdpa` at
     S 4096 / 10 heads and S 1024 / 20 heads, batch 2 and 3, and the VAE's
     f32 S 16384 / d 512 head at batch 2 and 1; `tca_flash` at both
     resolutions at the SDXL edit's masks; `group_norm_silu` at every
     SDXL UNet and 1024^2 VAE shape) and of the PixArt 512^2 edit of phase
     PX (heads of 72: `flash_sdpa` at S 1024 / 16 heads, batch 2 and 3;
     `tca_flash` at S 1024 / 8 heads after the parity split, at the
     PixArt edit's masks) and of phase 3D's perception models (heads of 64
     in float32, batch 1: `flash_sdpa` at S 1370 / 16 heads, ragged, and S
     4096 / 6 heads; timed in bf16 too, a cast no path runs) and of phase
     SV3D's video UNet (heads of 64 at batch 21: S 5184 / 5 heads, 1296 /
     10, 324 / 20 and the mid block's 81 / 20, all ragged; the VAE's f32
     S 5184 / d 512 head of a 576^2 frame; `group_norm_silu` at every video
     UNet norm, the temporal ones over the frame-folded [1, C, 21*H, W]
     slabs, and at the 576^2 VAE slabs) and of phases FLOW and MG (DIFT's
     UNet pass at batch 8: `flash_sdpa` and `group_norm_silu`; the
     MotionGuidance energy's UNet at batch 2 through the forward with
     logsumexp, dQ and dK/dV, and the VAE decoder's f32 head of 512 at
     S 4096 through the same at batch 1, batch 2 held and timed too, with
     the dropped-tile teeth and the library's autograd backward) and of
     phases RD, DE, SG and GD (their shapes are among the above: batch 1,
     2, 4 and 8 at every S; RegionDrag's batch-2 K/V of stream 1 and
     DragDiffusion's MasaCtrl K/V of stream 0 broadcast through the drag
     dispatch, held with teeth; GeoDiffuser's
     batch-1 gradient to the queries alone on the card against the twin's
     autograd; SelfGuidance's batch-2 gradient shapes are MG's), plus
     fully masked, ragged, Sk = 2 Sq (sdsa) and f32 cases, within limits
     scaled to each output tensor, with teeth (the twin with a key or query
     tile, or one CTA's positions, dropped must fail); `group_norm_silu`
     also against the two-pass float32 GroupNorm; the TCA VJP kernels on
     every output (composite, partials, logsumexps, dq, dk/dv of both key
     sets) at the TCA path shapes, with bggen, fully masked FG and f32
     cases, the backward kernels also at the masks path D passes (edit) and
     at bggen, timed against their three-pass and live bounds, two calls
     bit for bit, with teeth that a kernel skipping the live pass instead
     of the dead one must fail; `tca_flash` at the masks each path passes (edit for
     `generation` and `guided_generation`, bggen for `background_generation`,
     each path's per-edit time weighted at its own), with teeth that a
     kernel skipping the live pass instead of the dead one must fail, and
     at random rows; `group_norm_silu` also bit for bit against itself
     (a second call, and an NCHW input); time the kernel (eager, and in
     CUDA graphs), the twin and, as a yardstick only, the PyTorch call
     that computes the same (`F.scaled_dot_product_attention`, its
     forward or its autograd backward; `F.group_norm` then `F.silu`; none
     for TCA); check one gradient each through `flash_sdpa_diff`,
     `tca_flash_diff` and `GroupNormSiLU` on the card against the twin's
     autograd gradient on the CPU;
  3. the tiny config end to end on CUDA and on the CPU with the same f32
     weights and noise (TF32 off), final latents compared: `generation`
     (FREEFINE_FUSED_GN 0 and 1), `guided_generation`, and with
     FREEFINE_FUSED_GN=1 `background_generation` and
     `cross_image_composition` (2 sources); the batched lanes
     `BatchedFreeFine.generation` and `generation_shared_source` (2 cases,
     TCA; the per-case lane also at 3 cases, with the same launch counts)
     and, with FREEFINE_FUSED_GN=1, `background_generation_shared_source`;
     and, with FREEFINE_FUSED_GN=0, the latent gradient of one
     differentiated TCA UNet pass in modes edit and bggen; with
     FREEFINE_FUSED_GN unset (the default: the kernel on the card, the
     two-pass math on the CPU), `guided_generation` and that gradient; and
     `SDXLFreeFine` on the tiny SDXL config the same way (FREEFINE_FUSED_GN
     unset): `generation`, `guided_generation`, `background_generation`,
     `cross_image_composition` and the batched `generation` and
     `generation_shared_source` at 2 cases; and `FreeFine` on the tiny DiT
     and tiny PixArt configs the same way: `generation`,
     `background_generation`, `cross_image_composition`, the batched
     `generation` and `generation_shared_source` at 2 cases; on the tiny
     SD-1.5, DiT and PixArt configs one denoiser forward with IP-Adapter
     tokens at ip_scale 0.5 (the IP layers' weights equal on both sides);
     `generation` at GeoBench-3D's protocol on a coarse 3D edit
     (FREEFINE_FUSED_GN unset); the tiny DINOv2, Depth-Anything and
     EfficientSAM forwards, `make_depth_fn`, `re_edit_3d_depth` and
     `author_case` (masks equal but for 0.05 % of the pixels, images within
     1 level where they agree); the tiny video UNet, a 3-step tiny orbit,
     the tiny ViT, u2netp and its mask, the tiny `re_edit_3d_sv3d` and
     `generation` on its output (FREEFINE_FUSED_GN unset); `corr_block`
     and its gradient, the full-width RAFT at 64^2 (iters 2) and its
     gradient to the second image, the gradient through the tiny VAE's
     decode, the DIFT featurizer and `MotionGuidance.edit` (steps 2,
     recursion 2, the same draws) at guidance weight 0, and at 300 on the
     card alone (finite, moved; `phase_tiny_mg`); the tiny RegionDrag (both
     methods), DesignEdit (remove, pan, zoom, move; the refine removal
     reported, not held: C11), SelfGuidance and GeoDiffuser edits, 4 steps,
     the same draws (`phase_tiny_baselines`); the tiny DiffusionHandles
     edit at 4 and 5 input channels and the tiny drag with a 2-step LoRA,
     one null-text, guided, LoRA (gradient and Adam update) and drag-loop
     gradient each (`phase_tiny_dh_dd`; the drag with the union mask
     reported, not held: C12); InceptionV3-FID (its only width, batch 2),
     a tiny BLIP ImageReward and a tiny OpenCLIPText (`phase_tiny_ev`);
  4. the full-width SD-1.5 512^2 edit: `re_edit_2d`, then `generation` with
     50 DDIM steps, start 35, guidance 7.5, eta 1.0, TCA, bf16 random
     weights, with FREEFINE_FUSED_GN 0 and 1 in turns (one warm-up each, then
     0, 1, 1, 0); launch counters checked against the expected per-edit
     counts, and the launches by call shape against the shapes of phase 2;
  5. the full-width SD-1.5 512^2 energy-guided edit: `guided_generation`
     with its defaults (50 steps, start 25, energy on the first 0.6 of the
     25 regeneration steps, energy scale 2.0, TCA), FREEFINE_FUSED_GN=0;
     one warm-up and two
     timed edits, the same checks; one more edit measures the forward of the
     differentiated pass that no gradient reads (up blocks 2-3, conv_out);
  6. the full-width SD-1.5 512^2 object removal: `background_generation`
     with its defaults (50 steps, start 1, guidance 3.5, TCA) and
     FREEFINE_FUSED_GN=1; one warm-up and two timed edits, the same checks;
  7. the full-width SD-1.5 512^2 composition: `cross_image_composition` of
     2 source images, start 25, TCA, FREEFINE_FUSED_GN=1; the same checks,
     and the masked per-source attention launches counted;
  8. the differentiated SD-1.5 512^2 TCA edit pass: one regeneration UNet
     pass in mode "edit" over [u_e, r, c_e] at start step 35, built as
     `generation` builds it, the gradient of a fixed-cotangent loss on the
     edit streams' eps taken back to the edit latent, FREEFINE_FUSED_GN=0;
     one warm-up and three timed passes, launches checked against the
     counts worked out from the config;
  9. the full-width SD-1.5 512^2 batched lanes, `generation`'s protocol
     (50 steps, start 35, guidance 7.5, eta 1.0, TCA) over the cases
     `batch_cases` makes (one source image, a coarse edit each):
     `BatchedFreeFine.generation_shared_source` at batch 16 (path S) with
     FREEFINE_FUSED_GN 0 and 1 in turns (one warm-up each, then 0, 1, 1, 0)
     and `BatchedFreeFine.generation` at batch 8 (path B, FREEFINE_FUSED_GN=1;
     one warm-up, two timed calls); launch counters per call checked
     against the counts worked out from the config (the per-case lane's do
     not depend on the batch), s per call, s/edit, edits/min and peak
     memory; case 0 of the per-case lane against `generation` of the same
     case and seed (uint8 max and mean |diff|, reported); and C5's checks:
     a batch of one against `generation` of its case and seed, bit for bit
     (bf16, GN 1), and case 0 of a batch of 8 against `generation` with the
     f32 config, TF32 off (max and mean |diff| of the final latents and
     images, classified: rounding under 1e-2, a fault over 0.1; anything
     but rounding fails);
 9b. the rest of the main path (`phase_rest`), SD-1.5 512^2, bf16, phase
     4's pipe and edit: the checkpoint round trip (`save_pipeline` to a
     temporary directory, `load_sd15` back onto the card, seconds and GB/s
     each way, every tensor bit-equal, a `FreeFine(params=loaded)` edit
     equal to phase 4's pipe's), an edit from a 768x1024 source, an edit
     with `return_intermediates`, one `attention_maps` probe, and with
     FREEFINE_FUSED_GN unset (the "auto" default) a G edit, two timed E
     edits (`guided_generation`, phase 5's protocol) and one differentiated
     TCA pass (phase 8's), each with its launches and the GroupNorm shapes
     it launches among phase 2's;
 3D. the depth-based 3D edit (`phase_3d`), SD-1.5 512^2, bf16, phase 4's
     pipe and source: EfficientSAM ViT-S's box mask (`segment_with_box`,
     f32, 1024^2 inside), Depth-Anything ViT-L's depth (`make_depth_fn`,
     f32, 518^2 inside), the coarse edit (`re_edit_3d_depth`, ry 20
     degrees), `compute_correspondence`, the fast-marching background and
     the GeoBench-3D warp (`author_case`, focal 550, supersample 4), each
     timed with its launches checked (12 and 24 `flash_sdpa`, one per ViT
     block; none elsewhere), then `generation` at GeoBench-3D's protocol
     (50 DDIM steps, start 15, TCA to the end, end_scale 0, the target
     mask as draw mask and cons_area, no auto draw) with FREEFINE_FUSED_GN
     unset: one warm-up and two timed edits, launches 912 / 210 / 4322
     checked (path 3D, perception included);
 SV3D. the SV3D coarse 3D edit (`phase_sv3d`) on phase 4's pipe and
     source, FREEFINE_FUSED_GN unset: SV3D_p's video UNet (1.5 B random
     parameters, bf16, 21 frames), the ViT-H/14 image tower (f32), the SD
     VAE (bf16) and u2netp made on the card; `re_edit_3d_sv3d` at azimuth
     30, elevation 10 (576^2 crop, VAE encode, ViT-H token, the orbit, the
     frame decoded, matted and pasted back): 2 Euler steps (s per step),
     then the published 50 (cut only past SV3D_ORBIT_BUDGET_S; the count
     is printed), launches checked against the config (per step two passes
     of 16 `flash_sdpa` and 105 `group_norm_silu`, plus the VAE's); the
     stage times, a pass's time against its bf16 bound (its operations
     counted on the meta device), peak memory, the view mask's share and
     which branch ran;
     then `generation` at phase 3D's protocol on the coarse edit (one
     warm-up, two timed edits, launches checked; path SV3D is the two
     together);
 FLOW. RAFT at full width (`phase_flow`: iters 5, f32, random weights
     made on the card) between two 512^2 images, the forward and the
     forward and backward to the second image, times and peaks (no kernel
     of the table launched); one DIFT featurisation of a 512^2 image on
     phase 4's pipe (ensemble 8, t 261, FREEFINE_FUSED_GN unset), time,
     peak and launches checked (path DIFT);
 MG. `MotionGuidance.edit` on phase 4's pipe with that RAFT (`phase_mg`):
     GeoBench's weights, the schedule cut to 2 DDIM steps x 2 recursive
     steps (4 energy gradients); one warm-up under each GroupNorm route,
     then the default and "0" in turns (auto, 0, 0, auto), launches
     checked against the config; per energy gradient its device time and
     its split across UNet, decode and RAFT (CUDA events at the `mg::`
     ranges' boundaries), the peak, the launches by shape (path MG), the
     gradients finite and non-zero inside the object, and the protocol's
     500 gradients projected (labelled as a projection);
 RD. `RegionDrag.drag_regions` on phase 4's pipe (`phase_rd`) at
     GeoBench's protocol (50 steps, start 0.5, end 0.2; phase 4's object
     dragged onto its coarse edit's target mask), FREEFINE_FUSED_GN unset:
     one warm-up, two counted edits (802 `flash_sdpa`: 25 forward passes
     at batch 1 and 25 reverse at batch 2 with the hook stream's K/V, and
     the VAE's 2; 3102 `group_norm_silu`), s/edit, s/step, peak;
 DE. `DesignEdit.move` (`phase_de`, 50 steps, CFG 7.5; phase 4's move as
     fractions) the same way: the inversion of [image, image] at batch 2
     and the 8-stream denoise, launches checked;
 SG. `SelfGuidance.edit` (`phase_sg`, CFG 7.5, inversion 1.5, weight 15;
     phase 4's transform; the protocol's 50 DDPM steps cut in depth to
     GRADIENT_BASELINE_STEPS, 20): a cut warm-up under each GroupNorm
     route, then one 20-step edit counted, its gated gradients split
     into forward and backward by CUDA events (`GradStepTimer`); then cut
     edits of PAIRED_STEPS under the default and "0" in turns (auto, 0, 0,
     auto; ROADMAP C2), each counted;
 GD. `GeoDiffuser.edit` (`phase_gd`, lr 0.03; phase 4's edit; 20 of the
     protocol's 50 steps) the same way, its optimisation gradients timed;
 DH. `DiffusionHandles.edit` (`phase_dh`) on phase 4's pipe at GeoBench's
     protocol cut in depth (`DH_CUT`: prompt "", 50 steps, null-text
     inversion 2 gradient steps a step for the protocol's 10, 1 latent step
     a guided step for its 3, to step 38, weights 1.5 / 1.25, CFG 7.5),
     Depth-Anything ViT-L's depth normalised as GeoBench does: a shorter
     warm-up, one cut edit counted (1 + 15 x rows 3-5 a null-text step;
     every layer a guided step), its stages and steps timed, then one
     null-text step paired under GroupNorm auto and 0 (C2);
 DD. `DragDiffusion.drag` (`phase_dd`, `DD_CUT`: LoRA rank 16 20 steps for
     the protocol's 80, inversion 0.7, up to 20 drag iterations for its 80,
     MasaCtrl from step 4; at most 30 points of phase 4's move, the union
     mask) the same way, the drag
     loop's iterations read from the call, after a drag with every handle
     on its target that must stop at its first iteration with no update
     (its launches counted too); then one LoRA step paired (C2);
 G-XL. the full-width SDXL edit (`phase_sdxl`): `SDXLFreeFine` at
     `sdxl_pipeline_config()` (1024^2, bf16, full depth: UNet depths
     (1, 2, 10), dual text towers, added conditioning; random weights made
     on the card), `re_edit_2d`, then `generation` with phase 4's protocol
     and FREEFINE_FUSED_GN unset; one warm-up and two timed edits, s/edit
     and peak memory beside the card's line, launches checked against the
     counts worked out from the config (1712 `flash_sdpa`, 390
     `tca_flash`, 1432 `group_norm_silu`) and every launch shape among
     phase 2's (path XL of the `kernels` line);
 PX. the full-width PixArt edit (`phase_pixart`): `FreeFine` at
     `pixart_pipeline_config()` (512^2, bf16: the PixArt-XL-2 DiT, depth
     28, 16 heads of 72, and the T5-XXL caption tower, 24 layers of 4096;
     random weights made on the card); the T5 encode of the edit's
     prompts timed and checked finite and non-zero; `re_edit_2d`, then
     `generation` with phase 4's protocol and FREEFINE_FUSED_GN unset; one
     warm-up and two timed edits, s/edit and peak memory beside the card's
     line, launches checked against the counts worked out from the config
     (692 `flash_sdpa`, 150 `tca_flash`, 52 `group_norm_silu`, in the VAE
     alone) and every launch shape among phase 2's (path PX);
 EV. GeoBench's scoring (`phase_ev`): every metric encoder at its published
     width, random weights made on the card (f32; InceptionV3's
     convolutions and ImageReward's head He-scaled), written as
     safetensors and timed, one at a
     time; a synthetic results set written by `write_png` (4 sources x 2
     cases at 512^2, 70 real images); the FID family's unpadded tail batch
     against the zero-padded one the card runs; `metrics.main` at every metric but MD under
     PyTorch's TF32 defaults, counted (row 1's launches by shape from the
     configs), each metric's value and seconds, the peak; the same main on
     one source image's cases on the card and with --device cpu, each
     metric held within EV_TOL (path EV);
 10. one call of `group_norm_silu` at every path shape under
     torch.profiler: one `gn::` kernel launch per call (after the timed
     edits, which a profiler session could slow; with --profile before
     phase 4, as the process's first profiler session: after the profiled
     edits a session can miss a call this short);
 11. the result lines: the `kernels` JSON line (launches and per-edit times
     per path: each shape's time weighted by its launches counted in phases
     4 to 9, 3D, SV3D, FLOW, MG, RD, DE, SG, GD, DH, DD, G-XL and PX; path D
     is one differentiated pass, paths RD, DE, SG, GD, DH and DD one
     baseline edit each,
     paths S and B one batched call, path 3D one 3D edit with its
     perception calls, path SV3D one SV3D coarse edit and its refining
     generation, path DIFT one DIFT featurisation, path MG one
     MotionGuidance edit, path XL one SDXL edit, path PX one PixArt edit;
     `group_norm_silu` also has phase 9b's E and D under the default,
     E_gn_default and D_gn_default), the nvidia-smi line, and last
     `{"ok": true, "device": {...}}`.

A JSON record of the whole run is written to chiprun_out/chip_smoke.json.
Exits with code 2 and prints no result when CUDA is not available.
"""

import argparse
import contextlib
import functools
import gc
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet; dense): the bound of a call is
# the larger of bytes / HBM rate and its operations over the peak of their
# type, exponentials counted at 16 SFU ops/clk/SM x 132 SMs x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SFU_EXPS_PER_S = 16 * 132 * 1.98e9

# Each kernel is held to its twin, per shape, on two counts:
#  * max |out - ref| <= ABS_OF_MAX[dtype] * max |ref|: the limit scales with
#    the output (bf16 keeps 8 significant bits, so 2^-5 is 4 to 8 units in
#    the last place of the largest output), and one wrong row fails it;
#  * ||out - ref|| / ||ref|| <= REL_TOL[dtype] over the whole output.
# Both twins round P to bf16 before P.V as the kernels do, so in bf16 what
# remains is the output's own rounding; in f32 the summation order and the
# fast exp.  At every main-path shape the script also checks that the twin
# with its first DROP_KEYS keys left out fails these limits (`_teeth`).
ABS_OF_MAX = {"bfloat16": 2.0**-5, "float32": 1e-4}
REL_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
DROP_KEYS = 32  # the smallest key tile of either kernel
# GroupNorm's output is one rounding of a float32 value that the kernel and
# its twin compute alike to about 1e-6, so its limits are tighter: tight
# enough that the twin with one CTA's positions left out of the statistics
# fails them at every path shape (`_gn_dropped`).
GN_ABS_OF_MAX = {"bfloat16": 2.0**-6, "float32": 2e-6}
GN_REL_TOL = {"bfloat16": 1.5e-4, "float32": 2e-6}
LIMITS = {"group_norm_silu": (GN_ABS_OF_MAX, GN_REL_TOL)}

_T0 = time.perf_counter()


def log(*a):
    """Print and flush; a phase's first line carries the seconds since the
    script started."""
    if a and isinstance(a[0], str) and a[0].startswith("phase "):
        a = (f"[{time.perf_counter() - _T0:.1f} s]", *a)
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int, warmup: int = 2, repeats: int = 3) -> float:
    """Time per call of `fn` between CUDA events around `iters` eager calls,
    the least of `repeats` such timings: a stall of the host between two
    launches leaves the device idle inside a timing, so one timing of a few
    sub-millisecond calls can read several times the kernel's time."""
    import torch

    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def graph_ms(fn, iters: int = 10, replays: int = 3, stream=None) -> float:
    """Device time per call of `fn`: `iters` calls captured in one CUDA
    graph and replayed, so the host's launch rate does not set the time (it
    does for eager calls of a few microseconds of work).  `stream`: the
    stream to warm up and capture on (an autograd backward runs on its
    forward's stream, so that forward must have run on it)."""
    import torch

    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound(nbytes: float, flops: float, exps: float, dtype: str) -> dict:
    """Least time of a call (ms) and what sets it."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * max(flops / PEAK_FLOPS[dtype], exps / SFU_EXPS_PER_S)
    return dict(bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def flash_smem_report() -> list:
    """Dynamic shared memory of the `flash_sdpa` instantiation each route
    takes, one line per instantiation (head dims walked in steps of 8; a
    new line where the bytes change)."""
    from freefine_tpu_torch.ops import cuda_build
    from freefine_tpu_torch.ops import flash_attention as FA

    lib = cuda_build.library("flash_sdpa")
    rows = []
    for dtype, limit in FA._MAX_HEAD_DIM["flash_sdpa"].items():
        last = None
        for d in range(8, limit + 1, 8):
            route = FA.flash_route(dtype, d)
            smem = lib.flash_sdpa_smem_bytes(route, d)
            if smem < 0:
                raise AssertionError(f"flash_sdpa: no instantiation for {dtype} head dim {d}")
            if smem != last:
                rows.append(dict(route=FA.FLASH_ROUTES[route], from_head_dim=d, smem_bytes=smem))
                log(f"  flash_sdpa {FA.FLASH_ROUTES[route]} from head dim {d}: {smem} bytes of "
                    "dynamic shared memory")
                last = smem
    return rows


def bwd_smem_report(source: str, kernels) -> list:
    """Dynamic shared memory of the bf16 wgmma instantiations of a backward
    source (`flash_sdpa_bwd`, `tca_flash_bwd`; kernels: dQ then dK/dV), one
    line per instantiation (consumer warpgroups: one and two at every head
    dim, three where there is an instantiation; head dims walked in steps of
    8, a new line where the bytes change)."""
    import torch

    from freefine_tpu_torch.ops import cuda_build
    from freefine_tpu_torch.ops import flash_attention as FA

    smem_bytes = getattr(cuda_build.library(source), f"{source}_smem_bytes")
    rows = []
    for kernel, name in enumerate(kernels):
        for wgs in (1, 2, 3):
            last = None
            for d in range(8, FA._MAX_HEAD_DIM[name][torch.bfloat16] + 1, 8):
                smem = smem_bytes(d, kernel, wgs)
                if smem < 0 and wgs < 3:  # one and two exist at every head dim
                    raise AssertionError(f"{name}: no bf16 instantiation for head dim {d}")
                if smem != last and smem >= 0:
                    rows.append(dict(kernel=name, warpgroups=wgs, from_head_dim=d,
                                     smem_bytes=smem))
                    log(f"  {name} bf16_wgmma, {wgs} consumer warpgroup(s), from head dim "
                        f"{d}: {smem} bytes of dynamic shared memory")
                    last = smem
    return rows


def wgmma_spills(ptxas) -> None:
    """Fail on a spill in any wgmma instantiation (phase 1's ptxas rows)."""
    for r in ptxas:
        if "wgmma" in r["function"] and not ("0 bytes spill stores" in r["properties"]
                                             and "0 bytes spill loads" in r["properties"]):
            raise AssertionError(f"{r['function']} spills: {r['properties']}")


def ptxas_report(libs) -> list:
    """Registers, stack and spills of every kernel instantiation, from the
    ptxas report that `cuda_build` keeps beside each library."""
    rows = []
    for name, lib in sorted(libs.items()):
        lines = lib.with_suffix(".log").read_text().splitlines()
        for i, line in enumerate(lines):
            if "Function properties for" not in line:
                continue
            fn = line.split("Function properties for", 1)[1].strip()
            props = lines[i + 1].strip() if i + 1 < len(lines) else ""
            used = next((ln.split("Used", 1)[1].strip() for ln in lines[i + 2 : i + 4]
                         if "Used" in ln), "")
            rows.append(dict(library=name, function=fn, properties=props, used=used))
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r["function"] for r in rows),
                               capture_output=True, text=True, check=True).stdout.splitlines()
        for r, n in zip(rows, names):
            r["function"] = n
    for r in rows:
        log(f"  ptxas {r['library']}: {r['function'].split('(')[0]}: {r['properties']}; "
            f"{r['used']}")
    return rows


def gn_report(ptxas) -> list:
    """Each `gn::` instantiation (dtype; staged in shared memory by TMA,
    16-byte vectors: the resident and streamed routes; or one element per
    thread from global memory: the plain route) over the plans of the path
    shapes and GN_EXTRA: registers and spills (ptxas), routes, cluster
    sizes, the largest dynamic shared memory, and the fewest clusters of a
    plan's shape the card holds at once (`group_norm_active_clusters`).
    Fails on a spill in any instantiation or a plan the card cannot hold."""
    import torch

    from freefine_tpu_torch.ops import cuda_build
    from freefine_tpu_torch.ops import group_norm as G

    lib = cuda_build.library("group_norm")
    inst = {}
    for b, c, h, w, g, _, dtype, _ in path_gn_shapes() + GN_EXTRA:
        x = torch.empty((b, c, h, w), dtype=getattr(torch, dtype), device="cuda")
        plan = G.launch_plan(x.contiguous(memory_format=torch.channels_last), g)
        active = lib.group_norm_active_clusters(G._DTYPE_CODE[x.dtype], plan["vec"],
                                                plan["stages"], plan["cluster"],
                                                plan["smem_bytes"])
        if active <= 0:
            raise AssertionError(f"group_norm_silu {(b, c, h, w, g, dtype)}: plan {plan} holds "
                                 f"{active} clusters at once")
        e = inst.setdefault((dtype, plan["vec"], plan["stages"] > 0), dict(
            routes=set(), clusters=set(), max_smem_bytes=0, min_active_clusters=active))
        e["routes"].add(plan["route"])
        e["clusters"].add(plan["cluster"])
        e["max_smem_bytes"] = max(e["max_smem_bytes"], plan["smem_bytes"])
        e["min_active_clusters"] = min(e["min_active_clusters"], active)
    cxx = {"bfloat16": "__nv_bfloat16", "float32": "float"}
    rows = []
    for r in ptxas:
        if "gn::gn_" not in r["function"]:
            continue
        if "0 bytes spill stores" not in r["properties"] or "0 bytes spill loads" not in \
                r["properties"]:
            raise AssertionError(f"{r['function']} spills: {r['properties']}")
        name = r["function"].split("(")[0].removeprefix("void ")
        e = next((e for (dtype, vec, staged), e in inst.items() if name ==
                  f"gn::gn_cluster_kernel<{cxx[dtype]}, {vec}, {str(staged).lower()}>"), {})
        row = dict(name=name, used=r["used"], properties=r["properties"],
                   routes=sorted(e.get("routes", ())), clusters=sorted(e.get("clusters", ())),
                   max_smem_bytes=e.get("max_smem_bytes"),
                   min_active_clusters=e.get("min_active_clusters"))
        rows.append(row)
        log(f"  {name}: {row['used']}; {row['properties']}; routes {row['routes'] or 'none'} "
            f"at the GroupNorm shapes, clusters {row['clusters']}, up to "
            f"{row['max_smem_bytes']} bytes of dynamic shared memory, at least "
            f"{row['min_active_clusters']} clusters resident at once")
    if len(rows) != 4 or sum(bool(r["routes"]) for r in rows) != len(inst):
        raise AssertionError(f"gn:: instantiations {[r['name'] for r in rows]} do not match the "
                             f"plans' {sorted(inst)}")
    return rows


# ---------------------------------------------------------------------------
# Phase 2: kernels against their twins
# ---------------------------------------------------------------------------

# Cases per call of the batched lanes of phase 9: the shared-source lane
# (path S) and the per-case lane (path B).
BATCH_SHARED, BATCH_CASES = 16, 8
# (batch, heads, seq, head_dim, dtype, masked) of every call on the SD-1.5
# 512^2 paths: inversion batch 2 (generation), 3 (composition) and 1
# (object removal); regeneration batch 3 outside the TCA window, and batch
# 4 in composition, whose TCA layers also run the 2N = 4 per-source
# attentions with per-key masks; the energy's no-grad reference-feature pass
# batch 1; VAE mid-block f32 one head of 512 (batch 2, or 1 per image).  The
# batched lanes: S inverts its C cases at batch C and the source at 1, runs
# the capture pass at 1 and the edit pass at 2C; B inverts at 2C and
# regenerates at 3C; S encodes C + 1 images and decodes C, B encodes 2C and
# decodes C.
# Phases 4-9 count the launches at each shape and fail on a shape not timed
# here, or a shape timed here that no path launches.
LANE_UNET_BATCHES = (BATCH_SHARED, 2 * BATCH_SHARED, 2 * BATCH_CASES, 3 * BATCH_CASES)
LANE_VAE_BATCHES = (BATCH_SHARED + 1, BATCH_SHARED, 2 * BATCH_CASES, BATCH_CASES)
# phase FLOW's DIFT featurisation: one UNet pass over its ensemble
DIFT_ENSEMBLE = 8
FLASH_SHAPES = [
    (b, 8, s, d, "bfloat16", False) for b in sorted({1, 2, 3, 4, DIFT_ENSEMBLE,
                                                      *LANE_UNET_BATCHES})
    for s, d in ((4096, 40), (1024, 80), (256, 160), (64, 160))
] + [(4, 8, 4096, 40, "bfloat16", True), (4, 8, 1024, 80, "bfloat16", True)] + [
    (b, 1, 4096, 512, "float32", False) for b in sorted({2, 1, *LANE_VAE_BATCHES}, reverse=True)]
# The full-width SDXL edit (phase G-XL, `generation`'s protocol at 1024^2):
# heads of 64 everywhere, inversion batch 2 and regeneration batch 3 at
# S 4096 (10 heads) and S 1024 (20 heads); the VAE mid-block's float32 head
# of 512 at S 16384 (one encode of 2 images, one decode of 1).
XL_FLASH_SHAPES = [(b, h, s, 64, "bfloat16", False) for b in (2, 3)
                   for s, h in ((4096, 10), (1024, 20))] + [
    (b, 1, 16384, 512, "float32", False) for b in (2, 1)]
FLASH_SHAPES += XL_FLASH_SHAPES
# The full-width PixArt edit (phase PX, `generation`'s protocol at 512^2):
# the DiT's 16 heads of 72 at S 1024, inversion batch 2 and regeneration
# batch 3 (the VAE's f32 head is SD-1.5's).
PX_FLASH_SHAPES = [(b, 16, 1024, 72, "bfloat16", False) for b in (2, 3)]
FLASH_SHAPES += PX_FLASH_SHAPES
# The perception models of phase 3D, batch 1, float32 (the JAX package's
# default), unmasked: Depth-Anything's DINOv2 ViT-L/14 at 518^2 (1 + 37^2
# tokens, ragged; 16 heads of 64) and EfficientSAM ViT-S at 1024^2 (64^2
# tokens, 6 heads of 64)
PERCEPTION_FLASH_SHAPES = [(1, 16, 1370, 64, "float32", False),
                           (1, 6, 4096, 64, "float32", False)]
# the same in bf16, as a caller who casts the models would run them: timed
# and held like the rest, launched on no path
CAST_FLASH_SHAPES = [(b, h, s, d, "bfloat16", m) for b, h, s, d, _, m in PERCEPTION_FLASH_SHAPES]
FLASH_SHAPES += PERCEPTION_FLASH_SHAPES + CAST_FLASH_SHAPES
NOT_ON_A_PATH = {(b, h, s, s, d, dt, m) for b, h, s, d, dt, m in CAST_FLASH_SHAPES}
# The SV3D coarse 3D edit (phase SV3D): the video UNet's spatial
# self-attention at batch 21 (one clip of 21 frames), heads of 64, at the
# 72^2, 36^2 and 18^2 latents (5, 10 and 20 heads; ragged S 5184, 1296,
# 324) and the 9^2 mid block (S 81, under one tile); the SD VAE's float32
# head of 512 at S 5184 (a 576^2 frame, one encode and one decode).
SV3D_FLASH_SHAPES = [(21, 5, 5184, 64, "bfloat16", False), (21, 10, 1296, 64, "bfloat16", False),
                     (21, 20, 324, 64, "bfloat16", False), (21, 20, 81, 64, "bfloat16", False),
                     (1, 1, 5184, 512, "float32", False)]
FLASH_SHAPES += SV3D_FLASH_SHAPES
# Phase EV (GeoBench's scoring, `metrics.main`), float32, heads of 64, as
# (batch, heads, seq_q, seq_k, head_dim, dtype, masked): SUBC's DINO-v1
# ViT-B/16 at 224^2 (1 + 14^2 tokens, 12 heads, one image a call); IRS's BLIP:
# the ViT-L/16 (16 heads), BERT's self-attention over the 35 text tokens under
# their padding's key mask (below one key tile) and its cross-attention from
# them to the 197 image tokens; FID_DINO / FID_KD's DINOv2 ViT-B/14 at 224^2
# (1 + 16^2 tokens) over batches of EV_BATCH (a short one zero-padded on the
# card): the 8 generated images, and the real folder's full batch and tail.
EV_IMAGES, EV_CASES, EV_REAL, EV_BATCH = 4, 2, 70, 64
EV_FLASH_SHAPES = [(1, 12, 197, 197, 64, "float32", False), (1, 16, 197, 197, 64, "float32", False),
                   (1, 12, 35, 35, 64, "float32", True), (1, 12, 35, 197, 64, "float32", False),
                   (EV_BATCH, 12, 257, 257, 64, "float32", False)]
FLASH_SHAPES += EV_FLASH_SHAPES
# check-only (batch, heads, seq_q, seq_k, head_dim, dtype), masked with one
# fully masked batch row: ragged lengths, and sdsa's [own; ref] keys
# (Sk = 2 Sq) after the parity split (batch 2*3, 4 heads), which no timed
# path runs
FLASH_EXTRA = [(2, 8, 1000, 1000, 80, "bfloat16"), (2, 1, 300, 300, 512, "float32"),
               (3, 2, 77, 77, 16, "float32"), (3, 2, 77, 77, 16, "bfloat16"),
               (1, 2, 5, 5, 24, "bfloat16"), (6, 4, 4096, 8192, 40, "bfloat16"),
               (6, 4, 1024, 2048, 80, "bfloat16"), (6, 4, 256, 512, 160, "bfloat16"),
               (6, 1, 64, 128, 16, "float32"), (2, 4, 1000, 1000, 72, "bfloat16")]
# TCA after the head-parity split, 4 heads: batch 2*3 streams (single
# edits), then 2*2*C (the shared lane's [u_e, c_e] per case) and 2*3*C (the
# per-case lane)
TCA_EDIT_SHAPES = [(6, 4, 1024, 80, "bfloat16"), (6, 4, 4096, 40, "bfloat16")]
TCA_SHAPES = TCA_EDIT_SHAPES + [(b, 4, s, d, "bfloat16")
                                for b in (4 * BATCH_SHARED, 6 * BATCH_CASES)
                                for s, d in ((1024, 80), (4096, 40))]
# phase G-XL's TCA layers after the parity split (batch 2 * 3 streams):
# S 4096 at 5 heads and S 1024 at 10, held at the SDXL edit's masks ("xl")
XL_TCA_SHAPES = [(6, 5, 4096, 64, "bfloat16", "xl"), (6, 10, 1024, 64, "bfloat16", "xl")]
TCA_SHAPES += XL_TCA_SHAPES
# phase PX's TCA layers: S 1024, 16 heads of 72 regrouped as two blocks of 8
# by the parity split, at the PixArt edit's masks ("px")
PX_TCA_SHAPES = [(6, 8, 1024, 72, "bfloat16", "px")]
TCA_SHAPES += PX_TCA_SHAPES
TCA_EXTRA = [(6, 4, 1000, 40, "bfloat16"), (6, 1, 64, 16, "float32"),
             (6, 1, 64, 16, "bfloat16"), (4, 2, 33, 24, "bfloat16"),
             (6, 2, 1000, 72, "bfloat16")]
# The differentiated pass of energy guidance: batch 1, every self-attention
# of the plain UNet (forward with logsumexp; the backward reaches the 10
# layers upstream of the feature taps: down 6, mid 1, up block 1 3); and of
# the differentiated TCA edit pass (phase 8): batch 3, the 10 layers outside
# the TCA window (down 6, mid 1, up block 1 3), forward and backward; and
# MotionGuidance's energy gradient (phase MG): the UNet at batch 2 (every
# layer, forward and backward) and the VAE decoder's f32 mid-block head of
# 512 at S 4096, batch 1 (batch 2 held and timed too, a decode of two
# images that no path runs).
GRAD_SHAPES = [(b, 8, s, s, d, "bfloat16") for b in (1, 2, 3)
               for s, d in ((4096, 40), (1024, 80), (256, 160), (64, 160))]
MG_VAE_GRAD_SHAPES = [(b, 1, 4096, 4096, 512, "float32") for b in (1, 2)]
GRAD_SHAPES += MG_VAE_GRAD_SHAPES
NOT_ON_A_PATH.add((2, 1, 4096, 4096, 512, "float32", False))
# check-only, all masked with one fully masked batch row: ragged Sq != Sk,
# and f32 at the tiny configuration's head dims (16, 32, 64)
GRAD_EXTRA = [(2, 2, 1024, 1024, 80, "bfloat16"), (2, 2, 300, 77, 40, "bfloat16"),
              (2, 2, 100, 260, 160, "bfloat16"), (2, 2, 5, 7, 24, "bfloat16"),
              (2, 2, 64, 64, 16, "float32"), (2, 2, 16, 16, 32, "float32"),
              (2, 2, 50, 33, 64, "float32"), (2, 2, 4, 4, 64, "float32")]
AUTOGRAD_SHAPE = (1, 8, 1024, 80, "bfloat16")
# The TCA VJP kernels are timed at TCA_EDIT_SHAPES (the edit layout's masks);
# check-only (batch, heads, seq, head_dim, dtype, masks), masks as
# `_tca_masks` makes them: "bggen" (tq = 1, fg = 1 - obj on the even block),
# "empty_fg" (no fg key on the even block: every FG row fully masked, with
# weight cg * tq != 0), "parity" (ragged lengths, f32 at the tiny
# configuration's head dims)
TCA_GRAD_EXTRA = [(6, 4, 1024, 80, "bfloat16", "bggen"), (6, 4, 4096, 40, "bfloat16", "bggen"),
                  (6, 4, 1024, 80, "bfloat16", "empty_fg"),
                  (6, 4, 1000, 40, "bfloat16", "parity"), (4, 2, 33, 24, "bfloat16", "parity"),
                  (6, 1, 64, 16, "float32", "parity"), (4, 2, 50, 32, "float32", "empty_fg"),
                  (6, 1, 16, 32, "float32", "bggen")]
TCA_AUTOGRAD_SHAPE = (6, 4, 512, 80, "bfloat16")
TCA_PASSES = ("self", "fg", "bg")
TCA_GRAD_KERNELS = ("tca_flash_fwd_lse", "tca_flash_bwd_dq", "tca_flash_bwd_dkv")


def _inputs(gen, b, h, s, d, dtype, n):
    import torch

    dt = getattr(torch, dtype)
    return [torch.randn(b, s, h * d, generator=gen, device=gen.device).to(dt) for _ in range(n)]


def _parity_rows(gen, b, s, frac):
    """[b, s] rows: the even half random 0/1, the odd half ones (the
    head-parity split's unmasked block)."""
    import torch

    rows = torch.ones(b, s, device=gen.device)
    rows[: b // 2] = (torch.rand(b // 2, s, generator=gen, device=gen.device) > frac).float()
    return rows


# The attention twins materialise their [B, H, Sq, Sk] float32 logits (TCA
# three of them); at the batched lanes' shapes that would pass the card's
# memory, so a twin runs on slices of the batch whose logits stay within
# TWIN_LOGIT_BYTES (every single-edit shape fits in one slice).
TWIN_LOGIT_BYTES = 8 * 2**30


def by_batch(fn, *ops, logit_bytes_per_row: float, **kw):
    """fn over slices of the batch (dim 0 of every tensor operand),
    concatenated; one call where the whole batch fits."""
    import torch

    b = ops[0].shape[0]
    step = max(1, int(TWIN_LOGIT_BYTES // logit_bytes_per_row))
    if step >= b:
        return fn(*ops, **kw)
    return torch.cat([fn(*(x[i : i + step] if torch.is_tensor(x) else x for x in ops), **kw)
                      for i in range(0, b, step)])


def compare(out, ref) -> dict:
    diff = out.float() - ref.float()
    return dict(max_abs_err=float(diff.abs().max()), max_ref=float(ref.float().abs().max()),
                rel_err=float(diff.norm() / ref.float().norm()),
                finite=bool(out.float().isfinite().all()))


def err_over_tol(c: dict, dtype: str, name: str = "") -> float:
    """The larger of the two errors over its limit (kernel `name`'s, see
    LIMITS): <= 1 passes."""
    abs_of_max, rel_tol = LIMITS.get(name, (ABS_OF_MAX, REL_TOL))
    return max(c["max_abs_err"] / (abs_of_max[dtype] * c["max_ref"]),
               c["rel_err"] / rel_tol[dtype])


def _hold(name, out, ref, row, dtype=None, tensor=None):
    """Hold one output tensor to its twin; with several outputs per kernel
    (`tensor` names each) the row keeps each one's numbers and the worst."""
    c = compare(out, ref)
    c["err_over_tol"] = err_over_tol(c, dtype or row["dtype"], name)
    if tensor is None:
        row.update(c)
    else:
        row.setdefault("tensors", {})[tensor] = c
        for key in ("max_abs_err", "rel_err", "err_over_tol"):
            row[key] = max(row.get(key, 0.0), c[key])
        row["max_ref"] = max(row.get("max_ref", 0.0), c["max_ref"])
        row["finite"] = row.get("finite", True) and c["finite"]
    if not c["finite"] or not c["err_over_tol"] <= 1.0:
        raise AssertionError(f"{name} disagrees with its twin ({tensor or 'out'}): {row}")


def _teeth(name, ref, dropped, row, what="key", tensor=None):
    """The limits must reject the twin with its first DROP_KEYS keys (or
    queries) left out, as a kernel that skipped one tile would give.  The
    row keeps the weakest such margin (and each tensor's under `tensors`)."""
    e = err_over_tol(compare(dropped, ref), row["dtype"], name)
    row["dropped_tile_err_over_tol"] = min(row.get("dropped_tile_err_over_tol", e), e)
    if tensor is not None:
        row["tensors"][tensor][f"dropped_{what}_tile_err_over_tol"] = e
    if e <= 1.0:
        raise AssertionError(f"{name}: the limits accept a dropped {what} tile "
                             f"({tensor or 'out'}): {row}")


def check_flash(gen, shape, timed: bool):
    import torch
    import torch.nn.functional as F

    from freefine_tpu_torch.ops import flash_attention as FA

    if timed and len(shape) == 6:
        b, h, sq, d, dtype, masked = shape
        sk = sq
    elif timed:  # phase EV's, Sq and Sk apart
        b, h, sq, sk, d, dtype, masked = shape
    else:
        b, h, sq, sk, d, dtype = shape
        masked = True
    q, = _inputs(gen, b, h, sq, d, dtype, 1)
    k, v = _inputs(gen, b, h, sk, d, dtype, 2)
    mask = None
    if masked:
        mask = (torch.rand(b, sk, generator=gen, device=gen.device) > 0.5).float()
        if not timed:
            mask[b - 1] = 0.0  # a fully masked row block
    rows = 4.0 * h * sq * sk

    def twin(*ops):
        return by_batch(FA.flash_sdpa_reference, *ops, heads=h, logit_bytes_per_row=rows)

    out = FA.flash_sdpa(q, k, v, mask, heads=h)
    ref = twin(q, k, v, mask)
    torch.cuda.synchronize()
    row = dict(batch=b, heads=h, seq_q=sq, seq_k=sk, head_dim=d, dtype=dtype, masked=masked,
               key=(b, h, sq, sk, d, dtype, masked),
               route=FA.FLASH_ROUTES[FA.flash_route(q.dtype, d)])
    _hold("flash_sdpa", out, ref, row)
    if timed:
        n = min(DROP_KEYS, sk // 2)
        _teeth("flash_sdpa", ref, twin(q, k[:, n:], v[:, n:],
                                       None if mask is None else mask[:, n:]), row)
        itemsize = q.element_size()
        nbytes = 2 * b * (sq + sk) * h * d * itemsize + (0 if mask is None else 4 * b * sk)
        row.update(bound(nbytes, 4.0 * b * h * sq * sk * d, float(b * h * sq * sk), dtype))
        n = 3 if sq >= 4096 else 10
        row["kernel_ms"] = cuda_ms(lambda: FA.flash_sdpa(q, k, v, mask, heads=h), n)
        row["plain_ms"] = cuda_ms(lambda: twin(q, k, v, mask), n if b <= 4 else max(1, n * 4 // b))
        qh, kh, vh = (_sdpa_heads(x, h) for x in (q, k, v))
        keep = None if mask is None else (mask > 0)[:, None, None, :]
        row["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keep), n)
        # device time without the host's launch rate (eager calls of a few
        # microseconds of work time the host)
        row["kernel_graph_ms"] = graph_ms(lambda: FA.flash_sdpa(q, k, v, mask, heads=h))
        row["library_graph_ms"] = graph_ms(
            lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keep))
    return row


# The masks each path passes to the TCA kernels after the parity split, the
# layout its per-edit time is weighted at (`summarize`): `generation`,
# `guided_generation` and the differentiated edit pass D the edit layout,
# `background_generation` the bggen one, the batched lanes their own.
TCA_PATH_LAYOUT = {"generation": "edit", "guided": "edit", "bggen": "bggen", "D": "edit",
                   "S": "shared", "B": "cases", "XL": "edit", "PX": "edit", "3D": "edit",
                   "SV3D": "edit"}


@functools.lru_cache(maxsize=None)
def tca_layouts(seq: int, batch: int = 6, device: str = "cuda", model: str = "sd15"):
    """The fg and tq rows [batch, seq] the SD-1.5 paths pass to `tca_flash`
    (even-head block then odd-head block), built as the entry points build
    their states and `_tca_edit` / `_tca_bggen` their rows.  Batch 2 * 3
    (streams [u_e, r, c_e]) from phase 4's case: "edit" (fg = the source
    object, tq = the binarised target region on the even block, ones on the
    odd one) and "bggen" (fg = 1 - object on the even block, tq = 1
    everywhere).  Batch 2 * 2 * BATCH_SHARED: "shared", the shared lane's
    [u_e, c_e] per case of phase 9's cases; batch 2 * 3 * BATCH_CASES:
    "cases", the per-case lane's [u_e, r, c_e] per case.  With model "xl"
    ("px"), the "edit" layout of phase G-XL's SDXL 1024^2 case (phase PX's
    PixArt 512^2 case) alone."""
    import torch

    from freefine_tpu_torch import masks as mask_ops
    from freefine_tpu_torch.config import (
        pixart_pipeline_config,
        sd15_pipeline_config,
        sdxl_pipeline_config,
    )
    from freefine_tpu_torch.edit import build_mask_pyramid
    from freefine_tpu_torch.ops.attention import _parity_rows as parity_rows
    from freefine_tpu_torch.pipeline import edit_mask_states

    cfg = {"sd15": sd15_pipeline_config, "xl": sdxl_pipeline_config,
           "px": pixart_pipeline_config}[model]()
    h, w, lh, lw = cfg.height, cfg.width, cfg.latent_height, cfg.latent_width
    if batch != 6:
        name, cases, streams = {4 * BATCH_SHARED: ("shared", BATCH_SHARED, 2),
                                6 * BATCH_CASES: ("cases", BATCH_CASES, 3)}[batch]
        states, _, _ = edit_mask_states(cfg, device, batch_cases(cases, device), True, True)
        tgt = (states.fg_retain[seq] > 0).float()
        return {name: (parity_rows(states.fg_ref[seq], batch // 2),
                       parity_rows(tgt, batch // 2))}
    _, mask, _, tm = edit_case(cfg, device)
    t = lambda x: torch.as_tensor(np.asarray(x), device=device)  # noqa: E731
    em = mask_ops.prepare_various_mask(t(tm), t(mask), None, h, w, lh, lw, use_auto_draw=True,
                                       cons_area=t(np.zeros((h, w), np.uint8)),
                                       reduce_inp_artifacts=True)
    fg_ref = build_mask_pyramid(em.fg_ref, lh, lw)[seq]
    tgt = (build_mask_pyramid(em.fg_retain, lh, lw)[seq] > 0).float()
    streams = 3
    if model != "sd15":
        return {"edit": (parity_rows(fg_ref, streams), parity_rows(tgt, streams))}
    obj = build_mask_pyramid(mask_ops.prepare_mask_bggen(t(mask), h, w, lh, lw)[0], lh, lw)[seq]
    return {"edit": (parity_rows(fg_ref, streams), parity_rows(tgt, streams)),
            "bggen": (parity_rows(1.0 - obj, streams), torch.ones(2 * streams, seq,
                                                                   device=device))}


def _layout_numbers(lay):
    """A layout entry's times and bounds, for its row's own numbers (the
    row keeps its worst error over every layout)."""
    return {k: v for k, v in lay.items() if k not in ("err_over_tol", "swapped_pass_err_over_tol")}


def _tca_swapped(ops, h):
    """The twin as a kernel that skipped the wrong pass would give it: in
    each 64-query tile where the bf16 kernel skips FG or BG (weight 0), the
    other, live, mod pass's partial zeroed instead."""
    from freefine_tpu_torch.ops import flash_attention as FA

    tq, cg = ops[6], ops[7]
    _, parts, _ = FA.tca_flash_fwd_lse_reference(*ops, heads=h)
    rows = FA.tca_dead_passes(tq).repeat_interleave(FA.TCA_TILE_ROWS, dim=1)[:, : tq.shape[1]]
    parts = parts.clone()
    parts[1][rows[..., 2]] = 0.0  # BG dead: FG zeroed
    parts[2][rows[..., 1]] = 0.0  # FG dead: BG zeroed
    return FA._tca_composite(parts, tq, cg).to(ops[0].dtype)


def tca_bound(ops, h, dtype, live: bool) -> dict:
    """`bound` of one `tca_flash` call: bytes of the six operands, the masks
    and the output; two Q K^T products and, per pass, a P V product and one
    exponential per (query, key), for every pass (live=False) or for the
    passes the bf16 kernel runs on these masks (live=True: each 64-query
    tile's rows count its live passes, `tca_dead_passes`).  Also the passes
    counted per query row."""
    import torch

    from freefine_tpu_torch.ops import flash_attention as FA

    q, tq = ops[0], ops[6]
    b, s, e = q.shape
    d = e // h
    nbytes = 6 * b * s * e * q.element_size() + 2 * b * s * 4
    passes = 3.0 * b * s  # (query row, pass) pairs of the call
    if live:
        dead = FA.tca_dead_passes(tq)
        rows = torch.full(dead.shape[:2], float(FA.TCA_TILE_ROWS), device=dead.device)
        rows[:, -1] = s - FA.TCA_TILE_ROWS * (dead.shape[1] - 1)
        passes = float(((3 - dead.sum(-1)) * rows).sum())
    return dict(bound(nbytes, (4.0 * b * s + 2.0 * passes) * h * s * d, passes * h * s, dtype),
                passes_per_row=passes / (b * s))


def check_tca(gen, shape, timed: bool):
    """`tca_flash` at one shape.  Timed shapes: held and timed at the masks
    of the paths (`tca_layouts`: edit, bggen), with dropped-tile teeth and
    the swapped-pass teeth, and held at the random parity rows, where
    almost no 64-row tile lets the kernel skip a pass; check-only shapes at
    the random parity rows and at contiguous "blocks" of tq (whole tiles
    of tq 0 and 1, ragged ends)."""
    import torch

    from freefine_tpu_torch.ops import flash_attention as FA

    b, h, s, d, dtype, *model = shape
    q, ks, vs, km, vm = _inputs(gen, b, h, s, d, dtype, 5)
    cg = 0.7
    rows = 3 * 4.0 * h * s * s

    def twin(*ops):
        return by_batch(FA.tca_flash_reference, *ops, heads=h, logit_bytes_per_row=rows)

    layouts = {"parity": _tca_masks(gen, b, s, "parity")}
    if timed:
        layouts.update(tca_layouts(s, b, gen.device.type, *model))
    else:
        layouts["blocks"] = _tca_masks(gen, b, s, "blocks")
    row = dict(batch=b, heads=h, seq_q=s, seq_k=s, head_dim=d, dtype=dtype, masked=True,
               key=(b, h, s, s, d, dtype, True), layouts={})
    for name, (fg, tq) in layouts.items():
        ops = (q, ks, vs, km, vm, fg, tq, cg)
        out = FA.tca_flash(*ops, heads=h)
        ref = twin(*ops)
        torch.cuda.synchronize()
        _hold("tca_flash", out, ref, row, tensor=name)
        live = tca_bound(ops, h, dtype, True)
        lay = row["layouts"][name] = dict(
            dead_pass_tile_share=float(FA.tca_dead_passes(tq).any(-1).float().mean()),
            passes_per_row=live["passes_per_row"],
            err_over_tol=row["tensors"][name]["err_over_tol"])
        if not timed or name == "parity":
            continue
        n = min(DROP_KEYS, s // 2)
        _teeth("tca_flash", ref, twin(q, ks[:, n:], vs[:, n:], km[:, n:], vm[:, n:], fg[:, n:], tq,
                                      cg), row, tensor=name)
        swapped = by_batch(lambda *o: _tca_swapped(o, h), *ops, logit_bytes_per_row=rows)
        swapped = err_over_tol(compare(swapped, ref), dtype, "tca_flash")
        row["tensors"][name]["swapped_pass_err_over_tol"] = lay["swapped_pass_err_over_tol"] = \
            swapped
        if swapped <= 1.0:
            raise AssertionError(f"tca_flash: the limits accept a kernel that skips the live "
                                 f"pass ({name}): {row}")
        lay.update(live, three_pass_bound_ms=tca_bound(ops, h, dtype, False)["bound_ms"])
        n = 3 if s >= 4096 else 10
        lay["kernel_ms"] = cuda_ms(lambda: FA.tca_flash(*ops, heads=h), n)
        lay["kernel_graph_ms"] = graph_ms(lambda: FA.tca_flash(*ops, heads=h))
        if "plain_ms" not in row:  # the twin computes every pass on any masks
            row["plain_ms"] = cuda_ms(lambda: twin(*ops), n if b <= 6 else max(1, n * 6 // b))
        lay.update(plain_ms=row["plain_ms"], library_ms=None, library_graph_ms=None)
    if timed:  # the row's own numbers: its first path layout's (edit: paths G and E)
        paths = [name for name in row["layouts"] if name != "parity"]
        row.update(_layout_numbers(row["layouts"][paths[0]]))
        row["swapped_pass_err_over_tol"] = min(
            row["tensors"][name]["swapped_pass_err_over_tol"] for name in paths)
    return row


def _sdpa_heads(x, h):
    b, s, e = x.shape
    return x.reshape(b, s, h, e // h).transpose(1, 2).contiguous()


def check_grad(gen, shape, timed: bool):
    """The three kernels of the differentiable attention at one shape:
    {kernel name: row}.  The backward kernels and their twins get the same
    residuals (the twin's out and lse) and the same dO."""
    import torch
    import torch.nn.functional as F

    from freefine_tpu_torch.ops import flash_attention as FA

    b, h, sq, sk, d, dtype = shape
    q, do = _inputs(gen, b, h, sq, d, dtype, 2)
    k, v = _inputs(gen, b, h, sk, d, dtype, 2)
    mask = None
    if not timed:
        mask = (torch.rand(b, sk, generator=gen, device=gen.device) > 0.5).float()
        mask[b - 1] = 0.0  # a fully masked row block
    base = dict(batch=b, heads=h, seq_q=sq, seq_k=sk, head_dim=d, dtype=dtype,
                masked=mask is not None, key=(b, h, sq, sk, d, dtype, mask is not None))
    rows = {n: dict(base) for n in ("flash_sdpa_fwd_lse", "flash_sdpa_bwd_dq",
                                    "flash_sdpa_bwd_dkv")}
    rows["flash_sdpa_fwd_lse"]["route"] = FA.FLASH_ROUTES[FA.flash_route(q.dtype, d)]
    out, lse = FA.flash_sdpa_fwd_lse(q, k, v, mask, heads=h)
    ref_out, ref_lse = FA.flash_sdpa_fwd_lse_reference(q, k, v, mask, heads=h)
    delta = FA.row_delta(ref_out, do, h)
    res = (q, k, v, mask, do, ref_lse, delta)
    dq = FA.flash_sdpa_bwd_dq(*res, heads=h)
    dk, dv = FA.flash_sdpa_bwd_dkv(*res, heads=h)
    ref_dq = FA.flash_sdpa_bwd_dq_reference(*res, heads=h)
    ref_dk, ref_dv = FA.flash_sdpa_bwd_dkv_reference(*res, heads=h)
    torch.cuda.synchronize()
    r = rows["flash_sdpa_fwd_lse"]
    _hold("flash_sdpa_fwd_lse", out, ref_out, r, tensor="out")
    _hold("flash_sdpa_fwd_lse", lse, ref_lse, r, dtype="float32", tensor="lse")
    _hold("flash_sdpa_bwd_dq", dq, ref_dq, rows["flash_sdpa_bwd_dq"], tensor="dq")
    _hold("flash_sdpa_bwd_dkv", dk, ref_dk, rows["flash_sdpa_bwd_dkv"], tensor="dk")
    _hold("flash_sdpa_bwd_dkv", dv, ref_dv, rows["flash_sdpa_bwd_dkv"], tensor="dv")
    if not timed:
        return rows

    n = min(DROP_KEYS, sk // 2, sq // 2)
    _teeth("flash_sdpa_fwd_lse", ref_out, FA.flash_sdpa_fwd_lse_reference(
        q, k[:, n:], v[:, n:], heads=h)[0], r, tensor="out")
    _teeth("flash_sdpa_bwd_dq", ref_dq, FA.flash_sdpa_bwd_dq_reference(
        q, k[:, n:], v[:, n:], None, do, ref_lse, delta, heads=h), rows["flash_sdpa_bwd_dq"])
    dropped = FA.flash_sdpa_bwd_dkv_reference(q[:, n:], k, v, None, do[:, n:],
                                              ref_lse[..., n:].contiguous(),
                                              delta[..., n:].contiguous(), heads=h)
    for name, ref_t, drop_t in (("dk", ref_dk, dropped[0]), ("dv", ref_dv, dropped[1])):
        _teeth("flash_sdpa_bwd_dkv", ref_t, drop_t, rows["flash_sdpa_bwd_dkv"], what="query",
               tensor=name)

    it = q.element_size()
    bh, work = b * h, float(b * h * sq * sk)
    rows["flash_sdpa_fwd_lse"].update(bound(
        (2 * sq + 2 * sk) * bh * d * it + bh * sq * 4, 4.0 * work * d, work, dtype))
    rows["flash_sdpa_bwd_dq"].update(bound(
        (3 * sq + 2 * sk) * bh * d * it + 2 * bh * sq * 4, 6.0 * work * d, work, dtype))
    rows["flash_sdpa_bwd_dkv"].update(bound(
        (2 * sq + 4 * sk) * bh * d * it + 2 * bh * sq * 4, 8.0 * work * d, work, dtype))
    iters = 3 if sq >= 4096 else 10
    timings = {
        "flash_sdpa_fwd_lse": (lambda: FA.flash_sdpa_fwd_lse(q, k, v, heads=h),
                               lambda: FA.flash_sdpa_fwd_lse_reference(q, k, v, heads=h)),
        "flash_sdpa_bwd_dq": (lambda: FA.flash_sdpa_bwd_dq(*res, heads=h),
                              lambda: FA.flash_sdpa_bwd_dq_reference(*res, heads=h)),
        "flash_sdpa_bwd_dkv": (lambda: FA.flash_sdpa_bwd_dkv(*res, heads=h),
                               lambda: FA.flash_sdpa_bwd_dkv_reference(*res, heads=h)),
    }
    for name, (kern, plain) in timings.items():
        rows[name]["kernel_ms"] = cuda_ms(kern, iters)
        rows[name]["plain_ms"] = cuda_ms(plain, iters)
    for name in ("flash_sdpa_bwd_dq", "flash_sdpa_bwd_dkv"):
        rows[name]["kernel_graph_ms"] = graph_ms(timings[name][0])
    qh, kh, vh = (_sdpa_heads(x, h).requires_grad_() for x in (q, k, v))
    rows["flash_sdpa_fwd_lse"]["library_ms"] = cuda_ms(
        lambda: F.scaled_dot_product_attention(qh.detach(), kh.detach(), vh.detach()), iters)
    rows["flash_sdpa_fwd_lse"]["kernel_graph_ms"] = graph_ms(
        lambda: FA.flash_sdpa_fwd_lse(q, k, v, heads=h))
    rows["flash_sdpa_fwd_lse"]["library_graph_ms"] = graph_ms(
        lambda: F.scaled_dot_product_attention(qh.detach(), kh.detach(), vh.detach()))
    o = F.scaled_dot_product_attention(qh, kh, vh)
    doh = _sdpa_heads(do, h)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(o, (qh, kh, vh), doh, retain_graph=True), iters)
    bwd_graph_ms = library_bwd_graph_ms(qh, kh, vh, doh)
    for name in ("flash_sdpa_bwd_dq", "flash_sdpa_bwd_dkv"):
        rows[name]["library_ms"] = bwd_ms
        rows[name]["library_graph_ms"] = bwd_graph_ms
        rows[name]["library_call"] = ("autograd backward of F.scaled_dot_product_attention "
                                      f"(dq, dk and dv in one call; {o.grad_fn.name()})")
    return rows


def library_bwd_graph_ms(qh, kh, vh, doh) -> float:
    """The autograd backward of `F.scaled_dot_product_attention` in CUDA
    graphs: autograd runs a backward op on its forward op's stream, and syncs
    each leaf's gradient with the stream its grad accumulator was made on, so
    fresh leaves and their forward are made on the capture stream."""
    import torch
    import torch.nn.functional as F

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [x.detach().clone().requires_grad_() for x in (qh, kh, vh)]
        out = F.scaled_dot_product_attention(*leaves)
    return graph_ms(lambda: torch.autograd.grad(out, leaves, doh, retain_graph=True),
                    stream=side)


def check_autograd(record):
    """One gradient through `flash_sdpa_diff` on the card (forward with
    logsumexp, dQ and dK/dV kernels, wired by `FlashSDPA`) against the same
    autograd call on the CPU, where the function runs its plain twins."""
    import torch

    from freefine_tpu_torch.ops import flash_attention as FA

    b, h, s, d, dtype = AUTOGRAD_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = _inputs(gen, b, h, s, d, dtype, 4)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [x.detach().to(dev).requires_grad_() for x in (q, k, v)]
        out = FA.flash_sdpa_diff(*leaves, heads=h)
        if out.grad_fn is None:
            raise AssertionError("flash_sdpa_diff under grad mode returned no grad_fn")
        grads[dev] = torch.autograd.grad(out, leaves, do.to(dev))
    torch.cuda.synchronize()
    row = dict(batch=b, heads=h, seq_q=s, seq_k=s, head_dim=d, dtype=dtype, masked=False)
    for name, got, want in zip(("dq", "dk", "dv"), grads["cuda"], grads["cpu"]):
        _hold("flash_sdpa_diff autograd", got.cpu(), want, row, tensor=name)
    record["autograd_check"] = row
    log(f"  flash_sdpa_diff autograd on the card vs the CPU twin {AUTOGRAD_SHAPE}: "
        f"{row['err_over_tol']:.3f} of tol")


# RegionDrag's reverse pass (phase RD): every self-attention at batch 2 [x,
# hook], both streams attending with the hook stream's K/V, broadcast and
# made contiguous by the drag dispatch (`ops.attention._drag_attention`)
RD_SHARED_KV_SHAPES = [(2, 8, s, d, "bfloat16")
                       for s, d in ((4096, 40), (1024, 80), (256, 160), (64, 160))]
# GeoDiffuser's live edit-stream self-attention (phase GD): batch 1, the
# queries differentiated, the base stream's K/V held constant
GD_AUTOGRAD_SHAPES = [(1, 8, s, d, "bfloat16") for _, _, s, d, _ in RD_SHARED_KV_SHAPES]


def check_shared_kv(record) -> list:
    """`flash_sdpa` reached through the drag dispatch at the batch-2 shapes
    of RegionDrag (stream 1's K/V broadcast to both streams) and of
    DragDiffusion's MasaCtrl denoise (stream 0's), held to the twin on that
    broadcast, with teeth (a dropped key tile), and unlike the twin on each
    stream's own K/V.  -> check-only rows of `flash_sdpa`."""
    import torch

    from freefine_tpu_torch.baselines.drag_diffusion import DragDiffusion
    from freefine_tpu_torch.baselines.region_drag import RegionDrag
    from freefine_tpu_torch.ops import attention as A
    from freefine_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for label, cfg in (("RD", RegionDrag.drag_config()),
                       ("DD", DragDiffusion.masactrl_config())):
        src = cfg.kv_source_stream
        lo, _ = cfg.layer_range
        for b, h, s, d, dtype in RD_SHARED_KV_SHAPES:
            q, k, v = _inputs(gen, b, h, s, d, dtype, 3)
            out = A.edit_self_attention(q, k, v, h, cfg, None, lo, "up")
            kh, vh = k[src:src + 1].expand_as(k), v[src:src + 1].expand_as(v)
            ref = FA.flash_sdpa_reference(q, kh, vh, heads=h)
            torch.cuda.synchronize()
            row = dict(batch=b, heads=h, seq_q=s, seq_k=s, head_dim=d, dtype=dtype, masked=False,
                       key=(b, h, s, s, d, dtype, False),
                       path=f"{label}: stream {src}'s K/V broadcast")
            _hold("flash_sdpa", out, ref, row)
            n = min(DROP_KEYS, s // 2)
            _teeth("flash_sdpa", ref, FA.flash_sdpa_reference(q, kh[:, n:], vh[:, n:], heads=h),
                   row)
            row["own_kv_err_over_tol"] = err_over_tol(
                compare(FA.flash_sdpa_reference(q, k, v, heads=h), ref), dtype)
            if not row["own_kv_err_over_tol"] > 1.0:
                raise AssertionError(f"drag K/V check cannot tell the streams' K/V apart: {row}")
            _log_row("flash_sdpa", row, False)
            rows.append(row)
    record["rd_shared_kv_check"] = rows
    return rows


def check_gd_autograd(record):
    """GeoDiffuser's live self-attention at its batch-1 shapes: the gradient
    of `masked_sdpa` to the queries alone (the keys and values detached, as
    `geodiff_attention` holds the base stream's) on the card (the forward
    with logsumexp, dQ and dK/dV kernels) against autograd through the plain
    twin on the card.  SelfGuidance's batch-2 differentiated shapes are
    MotionGuidance's UNet shapes, held by `check_grad` (GRAD_SHAPES)."""
    import torch

    from freefine_tpu_torch.ops import attention as A
    from freefine_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = []
    for b, h, s, d, dtype in GD_AUTOGRAD_SHAPES:
        q, k, v, do = _inputs(gen, b, h, s, d, dtype, 4)
        grads = []
        for fn in (lambda x: A.masked_sdpa(x, k, v, h),
                   lambda x: FA.flash_sdpa_reference(x, k, v, heads=h)):
            x = q.detach().clone().requires_grad_()
            grads.append(torch.autograd.grad(fn(x), x, do)[0])
        torch.cuda.synchronize()
        row = dict(batch=b, heads=h, seq_q=s, seq_k=s, head_dim=d, dtype=dtype, masked=False)
        _hold("flash_sdpa_diff autograd (GD)", grads[0], grads[1], row, tensor="dq")
        rows.append(row)
        log(f"  flash_sdpa_diff dq, keys and values constant (GD) {(b, h, s, d, dtype)}: "
            f"{row['err_over_tol']:.3f} of tol")
    record["gd_autograd_check"] = rows


def _tca_masks(gen, b, s, kind):
    """fg and tq rows [b, s] in the head-parity layout (odd block all ones):
    "parity" random on the even block; "bggen" tq = 1 everywhere (fg, that
    is 1 - obj, random on the even block); "empty_fg" no fg key on the even
    block; "blocks" tq on the even block 1 on rows [s/4, s/2) and 0
    elsewhere, as an object's rows give it."""
    fg = _parity_rows(gen, b, s, 0.5)
    tq = _parity_rows(gen, b, s, 0.4)
    if kind == "bggen":
        tq.fill_(1.0)
    elif kind == "empty_fg":
        fg[: b // 2] = 0.0
    elif kind == "blocks":
        tq[: b // 2] = 0.0
        tq[: b // 2, s // 4 : s // 2] = 1.0
    return fg, tq


def _hold_lse(name, lse, ref, row, tensor):
    """A logsumexp against its twin's: a row whose every key is masked reads
    exactly -1e9 in both (the backward's P = 1 there rests on it); the other
    rows within the float32 limits."""
    import torch

    from freefine_tpu_torch.ops.flash_attention import NEG_INF

    full = ref == NEG_INF
    if not torch.equal(full, lse == NEG_INF):
        raise AssertionError(f"{name} ({tensor}): fully masked rows differ from the twin's")
    _hold(name, lse[~full], ref[~full], row, dtype="float32", tensor=tensor)
    row["tensors"][tensor]["fully_masked_rows"] = int(full.sum())


def tca_bwd_exps(ops, lse, h) -> float:
    """Exponentials the bf16 TCA backward kernels need on these masks and
    logsumexps (`csrc/tca_flash_bwd.cu`): per (query, key) one for self,
    and for the mod logit one where the key's fg is 0 or 1 and every pass
    that weights the row has a real logsumexp (above TCA_REAL_LSE), else one
    per live pass of the row's 64-query tile (`tca_dead_passes`).  Each of
    the two kernels takes them all."""
    import torch

    from freefine_tpu_torch.ops import flash_attention as FA

    q, fg, tq, cg = ops[0], ops[5], ops[6], ops[7]
    s = q.shape[1]
    dead = FA.tca_dead_passes(tq).repeat_interleave(FA.TCA_TILE_ROWS, dim=1)[:, :s]
    n_live = (~dead[..., 1:]).sum(-1).float()[:, None, :]  # [b, 1, s] live mod passes
    w = FA._tca_weights(tq, cg)[1:, :, 0]  # [2, b, s]
    real = ((lse[1:] > FA.TCA_REAL_LSE) | (w[:, :, None, :] == 0)).all(0)  # [b, h, s]
    binary = ((fg == 0) | (fg == 1)).float().sum(-1)[:, None, None]  # [b, 1, 1] keys
    mod = torch.where(real, binary + (s - binary) * n_live, s * n_live)
    return float((s + mod).sum())


def _tca_bwd_swapped(res, h):
    """The TCA VJP twins as kernels that skipped the wrong pass would give
    them: in each 64-query tile where one mod pass is dead, the other, live,
    pass's P zeroed instead.  -> (dq, dk_self, dv_self, dk_mod, dv_mod)."""
    from freefine_tpu_torch.ops import flash_attention as FA

    q, ks, vs, km, vm, fg, tq, cg, do, lse, delta = res
    probs = FA.tca_probs(q, ks, km, fg, lse, heads=h)
    dead = FA.tca_dead_passes(tq).repeat_interleave(FA.TCA_TILE_ROWS, dim=1)[:, : tq.shape[1]]
    probs[1] = probs[1].masked_fill(dead[:, None, :, None, 2], 0.0)  # BG dead: FG zeroed
    probs[2] = probs[2].masked_fill(dead[:, None, :, None, 1], 0.0)  # FG dead: BG zeroed
    terms = FA.tca_grad_terms(probs, vs, vm, tq, cg, do, delta, heads=h)
    del probs
    return (FA.tca_dq_from_terms(terms, q, ks, km, heads=h),
            *FA.tca_dkv_from_terms(terms, q, do, ks, vs, km, vm, heads=h))


TCA_DKV_NAMES = ("dk_self", "dv_self", "dk_mod", "dv_mod")


def _tca_bwd_layout(row, kname, ops, lse, h, costs, sfx):
    """A backward kernel's entry for one mask layout: its error, the dead
    64-query tiles' share, the exponentials per (query, key) it needs
    (`tca_bwd_exps`) and its live and three-pass bounds."""
    from freefine_tpu_torch.ops import flash_attention as FA

    q, tq = ops[0], ops[6]
    b, s, _ = q.shape
    work = float(b * h * s * s)
    exps = tca_bwd_exps(ops, lse, h)
    nbytes, flops = costs[kname]
    names = ("dq",) if kname == "tca_flash_bwd_dq" else TCA_DKV_NAMES
    return dict(
        bound(nbytes, flops, exps, row["dtype"]),
        three_pass_bound_ms=bound(nbytes, flops, 3.0 * work, row["dtype"])["bound_ms"],
        exps_per_pair=exps / work,
        dead_pass_tile_share=float(FA.tca_dead_passes(tq).any(-1).float().mean()),
        err_over_tol=max(row["tensors"][n + sfx]["err_over_tol"] for n in names))


def check_tca_grad(gen, shape, timed: bool):
    """The three kernels of the differentiable TCA at one shape: {kernel
    name: row}.  The backward kernels and their twins get the same
    residuals (the twin's partials, logsumexps and row sums) and dO.  Every
    shape: held at its masks (timed shapes: the random parity rows, with
    dropped-tile teeth and the three kernels timed there), and two calls of
    each backward kernel bit for bit.  Timed shapes also at the masks the
    paths pass (`tca_layouts`: edit, the layout of path D, and bggen),
    where the backward kernels are held, timed against their three-pass and
    live bounds (`tca_bwd_exps`), and their twins with the live pass zeroed
    instead of the dead one must fail the limits; the rows' own numbers are
    the edit layout's."""
    import torch

    from freefine_tpu_torch.ops import flash_attention as FA

    b, h, s, d, dtype, *kind = shape
    kind = kind[0] if kind else "parity"
    q, ks, vs, km, vm, do = _inputs(gen, b, h, s, d, dtype, 6)
    cg = 0.7
    layouts = {kind: _tca_masks(gen, b, s, kind)}
    if timed:
        layouts.update(tca_layouts(s, b, gen.device.type))
    base = dict(batch=b, heads=h, seq_q=s, seq_k=s, head_dim=d, dtype=dtype, masked=True,
                masks=kind, key=(b, h, s, s, d, dtype, True))
    rows = {n: dict(base) for n in TCA_GRAD_KERNELS}
    iters = 3 if s >= 4096 else 10
    # bytes: operands read once and outputs written once; operations: the
    # products these kernels do (csrc/tca_flash.cu, csrc/tca_flash_bwd.cu)
    # and three exponentials per (query, key), or (live) what the masks
    # leave the bf16 backward kernels
    it, el, bh = q.element_size(), b * s * h * d, b * h
    work = float(bh * s * s)
    masks, stats = 2 * b * s * 4, 3 * bh * s * 4
    costs = {"tca_flash_fwd_lse": (6 * el * it + 3 * el * 4 + masks + stats, 10.0 * work * d),
             "tca_flash_bwd_dq": (7 * el * it + masks + 2 * stats, 12.0 * work * d),
             "tca_flash_bwd_dkv": (10 * el * it + masks + 2 * stats, 16.0 * work * d)}
    for name, (fg, tq) in layouts.items():
        sfx = "" if name == kind else f" {name}"
        ops = (q, ks, vs, km, vm, fg, tq, cg)
        out, parts, lse = FA.tca_flash_fwd_lse(*ops, heads=h)
        ref_out, ref_parts, ref_lse = FA.tca_flash_fwd_lse_reference(*ops, heads=h)
        delta = FA.tca_row_deltas(ref_parts, do, tq, cg, heads=h)
        res = (*ops, do, ref_lse, delta)
        dq = FA.tca_flash_bwd_dq(*res, heads=h)
        dkv = FA.tca_flash_bwd_dkv(*res, heads=h)
        ref_dq = FA.tca_flash_bwd_dq_reference(*res, heads=h)
        ref_dkv = FA.tca_flash_bwd_dkv_reference(*res, heads=h)
        torch.cuda.synchronize()
        r = rows["tca_flash_fwd_lse"]
        _hold("tca_flash_fwd_lse", out, ref_out, r, tensor="out" + sfx)
        for i, p in enumerate(TCA_PASSES):
            _hold("tca_flash_fwd_lse", parts[i], ref_parts[i], r, tensor=f"o_{p}{sfx}")
            _hold_lse("tca_flash_fwd_lse", lse[i], ref_lse[i], r, tensor=f"lse_{p}{sfx}")
        _hold("tca_flash_bwd_dq", dq, ref_dq, rows["tca_flash_bwd_dq"], tensor="dq" + sfx)
        for tname, got, want in zip(TCA_DKV_NAMES, dkv, ref_dkv):
            _hold("tca_flash_bwd_dkv", got, want, rows["tca_flash_bwd_dkv"], tensor=tname + sfx)
        # no atomics, a fixed order of sums: a second call gives the same bits
        again = (FA.tca_flash_bwd_dq(*res, heads=h), *FA.tca_flash_bwd_dkv(*res, heads=h))
        if not all(torch.equal(x, y) for x, y in zip((dq, *dkv), again)):
            raise AssertionError(f"TCA backward kernels: two calls differ at {shape} ({name})")
        for kname in ("tca_flash_bwd_dq", "tca_flash_bwd_dkv"):
            rows[kname]["bit_identical_calls"] = True
        if not timed:
            continue
        if name == kind:
            n = min(DROP_KEYS, s // 2)
            kept = (q, ks[:, n:], vs[:, n:], km[:, n:], vm[:, n:], fg[:, n:], tq, cg)
            drop_out, drop_parts, _ = FA.tca_flash_fwd_lse_reference(*kept, heads=h)
            _teeth("tca_flash_fwd_lse", ref_out, drop_out, r, tensor="out")
            for i, p in enumerate(TCA_PASSES):
                _teeth("tca_flash_fwd_lse", ref_parts[i], drop_parts[i], r, tensor=f"o_{p}")
            _teeth("tca_flash_bwd_dq", ref_dq, FA.tca_flash_bwd_dq_reference(
                *kept, do, ref_lse, delta, heads=h), rows["tca_flash_bwd_dq"], tensor="dq")
            dropped = FA.tca_flash_bwd_dkv_reference(
                q[:, n:], ks, vs, km, vm, fg, tq[:, n:], cg, do[:, n:],
                ref_lse[..., n:].contiguous(), delta[..., n:].contiguous(), heads=h)
            for tname, want, drop in zip(TCA_DKV_NAMES, ref_dkv, dropped):
                _teeth("tca_flash_bwd_dkv", want, drop, rows["tca_flash_bwd_dkv"],
                       what="query", tensor=tname)
            timings = {
                "tca_flash_fwd_lse": (lambda: FA.tca_flash_fwd_lse(*ops, heads=h),
                                      lambda: FA.tca_flash_fwd_lse_reference(*ops, heads=h)),
                "tca_flash_bwd_dq": (lambda: FA.tca_flash_bwd_dq(*res, heads=h),
                                     lambda: FA.tca_flash_bwd_dq_reference(*res, heads=h)),
                "tca_flash_bwd_dkv": (lambda: FA.tca_flash_bwd_dkv(*res, heads=h),
                                      lambda: FA.tca_flash_bwd_dkv_reference(*res, heads=h)),
            }
            for kname, (kern, plain) in timings.items():
                nbytes, flops = costs[kname]
                rows[kname].update(bound(nbytes, flops, 3.0 * work, dtype))
                rows[kname]["kernel_ms"] = cuda_ms(kern, iters)
                rows[kname]["plain_ms"] = cuda_ms(plain, iters)
                rows[kname]["kernel_graph_ms"] = graph_ms(kern)
                # no single PyTorch call computes TCA
                rows[kname]["library_ms"] = rows[kname]["library_graph_ms"] = None
                if kname != "tca_flash_fwd_lse":
                    lay = _tca_bwd_layout(rows[kname], kname, ops, ref_lse, h, costs, sfx)
                    lay.update({k: rows[kname][k] for k in (
                        "kernel_ms", "kernel_graph_ms", "plain_ms", "library_ms",
                        "library_graph_ms")})
                    rows[kname]["layouts"] = {name: lay}
            continue
        # the backward kernels at a path's masks: swapped-pass teeth, timed
        swapped = _tca_bwd_swapped(res, h)
        torch.cuda.synchronize()
        teeth = {"tca_flash_bwd_dq": (("dq", ref_dq, swapped[0]),),
                 "tca_flash_bwd_dkv": (("dk_mod", ref_dkv[2], swapped[3]),
                                       ("dv_mod", ref_dkv[3], swapped[4]))}
        kerns = {"tca_flash_bwd_dq": lambda: FA.tca_flash_bwd_dq(*res, heads=h),
                 "tca_flash_bwd_dkv": lambda: FA.tca_flash_bwd_dkv(*res, heads=h)}
        for kname, kern in kerns.items():
            lay = _tca_bwd_layout(rows[kname], kname, ops, ref_lse, h, costs, sfx)
            lay["swapped_pass_err_over_tol"] = min(
                err_over_tol(compare(bad, want), dtype, kname) for _, want, bad in teeth[kname])
            if lay["swapped_pass_err_over_tol"] <= 1.0:
                raise AssertionError(f"{kname}: the limits accept a kernel that skips the live "
                                     f"pass ({name}): {lay}")
            lay["kernel_ms"] = cuda_ms(kern, iters)
            lay["kernel_graph_ms"] = graph_ms(kern)
            lay.update(plain_ms=rows[kname]["plain_ms"], library_ms=None, library_graph_ms=None)
            rows[kname]["layouts"][name] = lay
        del swapped
    if timed:  # the backward rows' own numbers: the edit layout's (path D)
        for kname in ("tca_flash_bwd_dq", "tca_flash_bwd_dkv"):
            row = rows[kname]
            row.update(_layout_numbers(row["layouts"]["edit"]))
            row["swapped_pass_err_over_tol"] = min(
                row["layouts"][n]["swapped_pass_err_over_tol"] for n in ("edit", "bggen"))
    return rows


def check_tca_autograd(record):
    """One gradient through `tca_flash_diff` on the card (`TCAFlash`: the
    forward with partials and logsumexps, the dQ and dK/dV kernels) against
    the same autograd call on the CPU, where it runs the plain twins."""
    import torch

    from freefine_tpu_torch.ops import flash_attention as FA

    b, h, s, d, dtype = TCA_AUTOGRAD_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(13)
    q, ks, vs, km, vm, do = _inputs(gen, b, h, s, d, dtype, 6)
    fg, tq = _tca_masks(gen, b, s, "parity")
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [x.detach().to(dev).requires_grad_() for x in (q, ks, vs, km, vm)]
        FA.reset_launch_counts()
        out = FA.tca_flash_diff(*leaves, fg.to(dev), tq.to(dev), 0.7, heads=h)
        if out.grad_fn is None:
            raise AssertionError("tca_flash_diff under grad mode returned no grad_fn")
        grads[dev] = torch.autograd.grad(out, leaves, do.to(dev))
        if dev == "cuda" and {k: FA.LAUNCHES[k] for k in ("tca_flash", *TCA_GRAD_KERNELS)} != {
                "tca_flash": 0, **{k: 1 for k in TCA_GRAD_KERNELS}}:
            raise AssertionError(f"tca_flash_diff on the card launched {FA.LAUNCHES}")
    torch.cuda.synchronize()
    row = dict(batch=b, heads=h, seq_q=s, seq_k=s, head_dim=d, dtype=dtype, masked=True)
    names = ("dq", "dk_self", "dv_self", "dk_mod", "dv_mod")
    for name, got, want in zip(names, grads["cuda"], grads["cpu"]):
        _hold("tca_flash_diff autograd", got.cpu(), want, row, tensor=name)
    record["tca_autograd_check"] = row
    log(f"  tca_flash_diff autograd on the card vs the CPU twin {TCA_AUTOGRAD_SHAPE}: "
        f"{row['err_over_tol']:.3f} of tol")


def norm_calls(cfg, kind: str) -> list:
    """The GroupNorm32 calls of one pass of `kind` ('unet', 'vae_encode' or
    'vae_decode'), in call order, worked out from the config: (channels,
    height, width, groups, eps, silu).  UNet resnets fuse the SiLU (eps
    1e-5), transformer input norms do not (1e-6); every VAE norm is 1e-6
    without SiLU (the VAE applies it after the cast).  The DiT has none."""
    from freefine_tpu_torch.config import DiTConfig

    calls = []
    if kind == "unet" and isinstance(cfg.unet, DiTConfig):
        return calls
    if kind == "unet":
        u, res = cfg.unet, [cfg.latent_height, cfg.latent_width]
        g, ch, nb = u.norm_num_groups, u.block_out_channels, len(u.block_out_channels)

        def resnet(cin, cout):
            calls.extend([(cin, *res, g, 1e-5, True), (cout, *res, g, 1e-5, True)])

        def transformer(c):
            calls.append((c, *res, g, 1e-6, False))

        prev, skips = ch[0], [ch[0]]
        for i, out in enumerate(ch):
            for _ in range(u.layers_per_block):
                resnet(prev, out)
                prev = out
                if u.down_block_has_attn[i]:
                    transformer(out)
                skips.append(out)
            if i < nb - 1:
                res = [(res[0] + 1) // 2, (res[1] + 1) // 2]
                skips.append(out)
        resnet(prev, prev)
        transformer(prev)
        resnet(prev, prev)
        for i, out in enumerate(reversed(ch)):
            for _ in range(u.layers_per_block + 1):
                resnet(prev + skips.pop(), out)
                prev = out
                if u.up_block_has_attn[i]:
                    transformer(out)
            if i < nb - 1:
                res = [2 * res[0], 2 * res[1]]
        calls.append((ch[0], *res, g, 1e-5, True))
        return calls

    v = cfg.vae
    g, ch, nb = v.norm_num_groups, v.block_out_channels, len(v.block_out_channels)

    def norm(c):
        calls.append((c, *res, g, 1e-6, False))

    def mid(c):
        for _ in range(5):  # resnet (2), attention (1), resnet (2)
            norm(c)

    if kind == "vae_encode":
        res, prev = [cfg.height, cfg.width], ch[0]
        for i, out in enumerate(ch):
            for _ in range(v.layers_per_block):
                norm(prev)
                norm(out)
                prev = out
            if i < nb - 1:
                res = [res[0] // 2, res[1] // 2]
        mid(prev)
        norm(prev)
        return calls
    rev = list(reversed(ch))
    res, prev = [cfg.latent_height, cfg.latent_width], rev[0]
    mid(prev)
    for i, out in enumerate(rev):
        for _ in range(v.layers_per_block + 1):
            norm(prev)
            norm(out)
            prev = out
        if i < nb - 1:
            res = [2 * res[0], 2 * res[1]]
    norm(rev[-1])
    return calls


# Batches of each pass of the paths that run the fused GroupNorm
# (FREEFINE_FUSED_GN=1): generation (phase 4: inversion 2, regeneration 3,
# one VAE encode of 2 images and one decode of the edit image; the guided
# edit and the differentiated pass of phase 9b run these and the UNet at
# batch 1, each image decoded alone as in generation), object
# removal (phase 6: 1 and 3; one image), composition (phase 7: 3 and 4; 3 encodes and 1 decode of
# one image each), and the batched lanes of phase 9 (S: inversions C and 1,
# capture 1, edit 2C, encode C + 1, decode C; B: inversion 2C, regeneration
# 3C, encode 2C, decode C).
GN_PATH_BATCHES = {
    "generation": {"unet": (2, 3), "vae_encode": (2,), "vae_decode": (1,)},
    # phase MG: the energy's UNet at batch 2 and decode of one image, the
    # source's encode; phase FLOW's DIFT: the ensemble's pass, one encode
    "MG": {"unet": (2,), "vae_encode": (1,), "vae_decode": (1,)},
    "DIFT": {"unet": (DIFT_ENSEMBLE,), "vae_encode": (1,)},
    # phases RD, DE, SG and GD: RegionDrag's forward at 1 and reverse at 2;
    # DesignEdit's move, the inversion of [image, image] at 2 and the 8
    # streams (its remove / pan / zoom: 1 and 4); SelfGuidance's CFG passes
    # at 2; GeoDiffuser's inversion at 1 and [base, edit] at 2; one encode
    # (DesignEdit's move two) and one decode of one image each
    "RD": {"unet": (1, 2), "vae_encode": (1,), "vae_decode": (1,)},
    "DE": {"unet": (1, 2, 4, 8), "vae_encode": (1,), "vae_decode": (1,)},
    "SG": {"unet": (2,), "vae_encode": (1,), "vae_decode": (1,)},
    "GD": {"unet": (1, 2), "vae_encode": (1,), "vae_decode": (1,)},
    "bggen": {"unet": (1, 3), "vae_encode": (1,), "vae_decode": (1,)},
    "compose": {"unet": (3, 4), "vae_encode": (1,), "vae_decode": (1,)},
    "S": {"unet": (BATCH_SHARED, 1, 2 * BATCH_SHARED), "vae_encode": (BATCH_SHARED + 1,),
          "vae_decode": (BATCH_SHARED,)},
    "B": {"unet": (2 * BATCH_CASES, 3 * BATCH_CASES), "vae_encode": (2 * BATCH_CASES,),
          "vae_decode": (BATCH_CASES,)},
}


# Phase G-XL's passes (the SDXL config): generation's, at 1024^2; phase PX's
# (the PixArt config, whose DiT has no GroupNorm): generation's, at 512^2.
GN_XL_PATH_BATCHES = {"XL": {"unet": (2, 3), "vae_encode": (2,), "vae_decode": (1,)}}
GN_PX_PATH_BATCHES = {"PX": {"unet": (2, 3), "vae_encode": (2,), "vae_decode": (1,)}}


def gn_shapes(cfg, paths=GN_PATH_BATCHES) -> list:
    """(batch, channels, height, width, groups, eps, dtype, silu) of every
    `group_norm_silu` call of `paths` (by default the SD-1.5 paths) on
    `cfg` (each channels-last, as the convolutions pass it on)."""
    out = set()
    for passes in paths.values():
        for kind, batches in passes.items():
            dtype = str(cfg.unet.dtype if kind == "unet" else cfg.vae.dtype).split(".")[-1]
            out |= {(b, c, h, w, g, eps, dtype, silu) for b in batches
                    for c, h, w, g, eps, silu in norm_calls(cfg, kind)}
    return sorted(out)


def path_gn_shapes() -> list:
    """`gn_shapes` of every path: SD-1.5's, phase G-XL's (SDXL), phase
    PX's (PixArt) and phase SV3D's (`sv3d_gn_shapes`)."""
    from freefine_tpu_torch.config import (
        pixart_pipeline_config,
        sd15_pipeline_config,
        sdxl_pipeline_config,
    )

    return sorted(set(gn_shapes(sd15_pipeline_config()))
                  | set(gn_shapes(sdxl_pipeline_config(), GN_XL_PATH_BATCHES))
                  | set(gn_shapes(pixart_pipeline_config(), GN_PX_PATH_BATCHES))
                  | set(sv3d_gn_shapes()))


# SV3D's frame: the object's 576^2 square, a 72^2 latent
SV3D_SIZE, SV3D_LATENT = 576, 72


def video_unet_calls(u, side: int) -> tuple:
    """One `VideoUNet` pass at a side^2 latent, worked out from its config
    (in call order): (its GroupNorm32 calls as (batch, channels, height,
    width, groups, eps): per res block the spatial norms at batch T and
    the temporal ones over the frame-folded [1, C, T*H, W], per
    transformer its input norm (eps 1e-6), the output norm; its
    `masked_sdpa` calls as (batch T, heads, S, head dim), one per
    transformer, the mid block's included)."""
    t, g, ch0, n = u.num_frames, u.norm_num_groups, u.model_channels, len(u.channel_mult)
    norms, attns, res = [], [], side

    def resblock(cin, cout):
        norms.extend([(t, cin, res, res, g, 1e-5), (t, cout, res, res, g, 1e-5),
                      (1, cout, t * res, res, g, 1e-5), (1, cout, t * res, res, g, 1e-5)])

    def transformer(c):
        norms.append((t, c, res, res, g, 1e-6))
        attns.append((t, c // u.num_head_channels, res * res, u.num_head_channels))

    ch, skips = ch0, [ch0]
    for lvl, mult in enumerate(u.channel_mult):
        for _ in range(u.num_res_blocks):
            resblock(ch, ch0 * mult)
            ch = ch0 * mult
            if u.attention_levels[lvl]:
                transformer(ch)
            skips.append(ch)
        if lvl < n - 1:
            res = (res + 1) // 2
            skips.append(ch)
    resblock(ch, ch)
    transformer(ch)
    resblock(ch, ch)
    for lvl in reversed(range(n)):
        for _ in range(u.num_res_blocks + 1):
            resblock(ch + skips.pop(), ch0 * u.channel_mult[lvl])
            ch = ch0 * u.channel_mult[lvl]
            if u.attention_levels[lvl]:
                transformer(ch)
        if lvl > 0:
            res *= 2
    norms.append((t, ch, res, res, g, 1e-5))
    return norms, attns


def video_unet_pass_flops(u, side: int) -> dict:
    """Floating-point operations of one `VideoUNet` pass at a side^2 latent:
    its GEMMs and convolutions counted by `torch.utils.flop_counter` over
    a trace on the meta device (GroupNorms and attention stubbed: no
    weights, no device), its `masked_sdpa` calls' 4*B*H*S^2*d
    (`video_unet_calls`), and its plain attentions' 4*B*Sq*Sk*E (the
    temporal self-attention over T keys, the one-key cross-attention)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from freefine_tpu_torch.models import video_unet as V
    from freefine_tpu_torch.models.layers import GroupNorm32

    plain = []
    saved = V.masked_sdpa, V.sdpa, GroupNorm32.forward
    V.masked_sdpa = lambda q, k, v, heads: q
    V.sdpa = lambda q, k, v, heads: (
        plain.append(4 * q.shape[0] * q.shape[1] * k.shape[1] * q.shape[2]), q)[1]
    GroupNorm32.forward = lambda self, x, silu=False: x
    t = u.num_frames
    try:
        with torch.device("meta"):
            model = V.VideoUNet(u)
            with FlopCounterMode(display=False) as counter:
                model(torch.zeros(t, side, side, u.in_channels), torch.zeros(t),
                      torch.zeros(t, 1, u.context_dim), torch.zeros(t, u.adm_in_channels))
    finally:
        V.masked_sdpa, V.sdpa, GroupNorm32.forward = saved
    _, attns = video_unet_calls(u, side)
    return dict(gemm_conv=counter.get_total_flops(),
                flash_sdpa=sum(4 * b * h * s * s * d for b, h, s, d in attns),
                plain_attention=sum(plain))


def sv3d_vae_config():
    """The SD VAE at SV3D's 576^2 frame, as `norm_calls` takes a config."""
    import types

    from freefine_tpu_torch.config import VAEConfig

    return types.SimpleNamespace(vae=VAEConfig(), height=SV3D_SIZE, width=SV3D_SIZE,
                                 latent_height=SV3D_LATENT, latent_width=SV3D_LATENT)


def sv3d_gn_shapes() -> list:
    """`group_norm_silu` shapes of phase SV3D's coarse edit: every video
    UNet norm (bf16, no SiLU: the module applies it after the cast) and
    the VAE's at 576^2 (one encode, one decode, batch 1)."""
    from freefine_tpu_torch.models.video_unet import sv3d_config

    norms, _ = video_unet_calls(sv3d_config(), SV3D_LATENT)
    out = {(b, c, h, w, g, eps, "bfloat16", False) for b, c, h, w, g, eps in norms}
    vcfg = sv3d_vae_config()
    dtype = str(vcfg.vae.dtype).split(".")[-1]
    for kind in ("vae_encode", "vae_decode"):
        out |= {(1, c, h, w, g, eps, dtype, silu) for c, h, w, g, eps, silu in
                norm_calls(vcfg, kind)}
    return sorted(out)


# check-only: the eps / SiLU pairings no path runs at full width, float32
# with 16-byte vectors (the tiny config) and the 1-element route (C not a
# multiple of the vector width); each also from an NCHW input (the copy the
# wrapper makes first)
GN_EXTRA = [(2, 320, 64, 64, 32, 1e-6, "bfloat16", True),
            (2, 320, 64, 64, 32, 1e-5, "bfloat16", False),
            (2, 64, 16, 16, 8, 1e-5, "float32", True),
            (2, 128, 1, 1, 8, 1e-5, "float32", True),
            (2, 64, 7, 9, 8, 1e-6, "float32", False),
            (3, 96, 20, 20, 32, 1e-5, "bfloat16", True),
            (2, 18, 8, 8, 6, 1e-5, "float32", True),
            (2, 60, 30, 25, 6, 1e-6, "bfloat16", False)]


def _gn_inputs(gen, b, c, h, w, dtype):
    """x with per-channel means in [-3, 3) and spreads in [0.3, 3), as
    activations have; float32 scale and bias."""
    import torch

    dev = gen.device
    m = torch.rand(c, generator=gen, device=dev) * 6 - 3
    sd = torch.rand(c, generator=gen, device=dev) * 2.7 + 0.3
    x = torch.randn(b, c, h, w, generator=gen, device=dev) * sd[:, None, None] + m[:, None, None]
    scale = torch.randn(c, generator=gen, device=dev) * 0.5 + 1.0
    bias = torch.randn(c, generator=gen, device=dev) * 0.2
    return x.to(getattr(torch, dtype)), scale, bias


def _gn_dropped(x, scale, bias, plan, *, num_groups, eps, apply_silu):
    """The twin with one CTA's positions left out of its groups' statistics,
    as a kernel whose cluster merge lost one rank's partial would give:
    rank 0's `rows_per_cta` positions; with a cluster of one CTA, its first
    TMA box, or with a single box one per-channel slot of the CTA's merge
    (each group's first channel)."""
    import torch

    b, c, h, w = x.shape
    xf = x.float().reshape(b, num_groups, c // num_groups, h * w)
    if plan["cluster"] > 1:
        kept = xf[..., plan["rows_per_cta"]:]
    elif 0 < plan["box_rows"] < h * w:
        kept = xf[..., plan["box_rows"]:]
    else:
        kept = xf[:, :, 1:]
    kept = kept.reshape(b, num_groups, -1)
    mean = kept.mean(-1, keepdim=True)
    var = (kept * kept).mean(-1, keepdim=True) - mean * mean
    y = ((xf.reshape(b, num_groups, -1) - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * scale[None, :, None, None] + bias[None, :, None, None]
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _gn_call_groups(rows, cap_bytes: int = 1 << 30):
    """`rows` in order, cut into groups whose inputs together stay under
    `cap_bytes` (a row larger than that is a group of its own)."""
    group, size = [], 0
    for row in rows:
        b, c, h, w, *_ = row["key"]
        n = 4 * b * c * h * w
        if group and size + n > cap_bytes:
            yield group
            group, size = [], 0
        group.append(row)
        size += n
    if group:
        yield group


def gn_launches_per_call(rows):
    """Device kernels that one `group_norm_silu` call launches at each timed
    shape, into each row; fails unless it is one `gn::` kernel.  The shapes
    go in groups of about 1 GiB of inputs (`_gn_call_groups`), one
    torch.profiler session a group (up to three if a session records no
    device event at all, or fewer or more than the group's calls): the
    inputs are made and each shape called once
    before the session, then each shape is called once, synchronised,
    inside it, so the session's device events in order of start are the
    calls' kernels in order of call (the device clock's offset from the
    host's can move a kernel past the host's range of its call, not past
    the next call's kernel).  One session a shape left a session with no
    device event after a few hundred in one process.  Run after the timed
    edits (a profiler session can leave the host's launches slower for the
    rest of the process), and before any other profiler session (after the
    profiled edits of --profile, a session recorded no device event of a
    call this short)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from freefine_tpu_torch.ops import group_norm as G

    gen = torch.Generator(device="cuda").manual_seed(0)
    for group in _gn_call_groups(rows):
        calls = []
        for row in group:
            b, c, h, w, g, eps, dtype, silu = row["key"]
            x, scale, bias = _gn_inputs(gen, b, c, h, w, dtype)
            calls.append(functools.partial(
                G.group_norm_silu, x.contiguous(memory_format=torch.channels_last), scale,
                bias, num_groups=g, eps=eps, apply_silu=silu))
            calls[-1]()
        torch.cuda.synchronize()
        # a session now and then records no device event at all, or drops
        # one (5 of 6 calls seen); a call that launches other than one
        # kernel does so in every session and still fails below
        for attempt in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for call in calls:
                    call()
                    torch.cuda.synchronize()
            kernels = sorted((e for e in prof.events()
                              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA),
                             key=lambda e: e.time_range.start)
            if len(kernels) == len(group):
                break
        del calls
        if len(kernels) != len(group):
            raise AssertionError(f"group_norm_silu: {len(group)} calls at {group[0]['key']} ... "
                                 f"{group[-1]['key']} launched {len(kernels)} kernels "
                                 f"{sorted({e.name for e in kernels})}, not one each")
        for row, e in zip(group, kernels):
            row.update(kernels_per_call=1, kernel_names=[e.name],
                       profiler_sessions=attempt + 1)
            log(f"  group_norm_silu {row['key']}: 1 kernel launch per call "
                f"{e.name.split('(')[0]}" + (f" ({attempt + 1} profiler sessions)"
                                              if attempt else ""))
            if "gn::gn_" not in e.name:
                raise AssertionError(f"group_norm_silu {row['key']}: one call launched "
                                     f"{e.name}, not one gn:: kernel")


def check_gn(gen, shape, timed: bool):
    import torch
    import torch.nn.functional as F

    from freefine_tpu_torch.ops import group_norm as G

    b, c, h, w, g, eps, dtype, silu = shape
    x, scale, bias = _gn_inputs(gen, b, c, h, w, dtype)
    nchw = x
    x = x.contiguous(memory_format=torch.channels_last)
    kw = dict(num_groups=g, eps=eps, apply_silu=silu)
    out = G.group_norm_silu(x, scale, bias, **kw)
    again = G.group_norm_silu(x, scale, bias, **kw)
    ref = G.group_norm_silu_reference(x, scale, bias, **kw)
    two_pass = G.group_norm_reference(x, scale, bias, **kw)
    torch.cuda.synchronize()
    plan = G.launch_plan(x, g)
    row = dict(batch=b, channels=c, height=h, width=w, groups=g, eps=eps, dtype=dtype, silu=silu,
               key=shape, plan=plan, route=f"{plan['route']}, cluster {plan['cluster']}")
    if not out.is_contiguous(memory_format=torch.channels_last):
        raise AssertionError(f"group_norm_silu {shape}: output is not channels-last")
    if not torch.equal(out, again):
        raise AssertionError(f"group_norm_silu {shape}: two calls differ")
    if not torch.equal(G.group_norm_silu(nchw, scale, bias, **kw), out):
        raise AssertionError(f"group_norm_silu {shape}: NCHW input differs from channels-last")
    _hold("group_norm_silu", out, ref, row, tensor="vs_twin")
    _hold("group_norm_silu", out, two_pass, row, tensor="vs_two_pass")
    if not timed:
        return row
    _teeth("group_norm_silu", ref, _gn_dropped(x, scale, bias, plan, **kw), row,
           what="cta", tensor="vs_twin")
    n = x.numel()
    row.update(bound(2 * n * x.element_size() + 8 * c, 8.0 * n, float(n if silu else 0),
                     "float32"))
    row["kernel_ms"] = graph_ms(lambda: G.group_norm_silu(x, scale, bias, **kw))
    row["kernel_eager_ms"] = cuda_ms(lambda: G.group_norm_silu(x, scale, bias, **kw), 10)
    row["plain_ms"] = graph_ms(lambda: G.group_norm_silu_reference(x, scale, bias, **kw))
    row["f32_route_ms"] = graph_ms(lambda: G.group_norm_reference(x, scale, bias, **kw))
    sc, bs = scale.to(x.dtype), bias.to(x.dtype)

    def library():
        y = F.group_norm(x, g, sc, bs, eps)
        return F.silu(y) if silu else y

    row["library_ms"] = graph_ms(library)
    row["library_call"] = "F.group_norm then F.silu, in x's dtype"
    return row


def check_gn_autograd(record):
    """One gradient through `GroupNormSiLU` on the card (kernel forward,
    two-pass backward) against the same autograd call on the CPU twin."""
    import torch

    from freefine_tpu_torch.ops import group_norm as G

    b, c, h, w, g, eps, dtype, silu = GN_AUTOGRAD_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(11)
    x, scale, bias = _gn_inputs(gen, b, c, h, w, dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in (x, scale, bias)]
        y = G.group_norm_silu_diff(*leaves, num_groups=g, eps=eps, apply_silu=silu)
        if y.grad_fn is None:
            raise AssertionError("group_norm_silu_diff under grad mode returned no grad_fn")
        grads[dev] = torch.autograd.grad(y, leaves, dy.to(dev))
    torch.cuda.synchronize()
    row = dict(batch=b, channels=c, height=h, width=w, groups=g, eps=eps, dtype=dtype, silu=silu)
    for name, got, want in zip(("dx", "dscale", "dbias"), grads["cuda"], grads["cpu"]):
        _hold("GroupNormSiLU autograd", got.cpu(), want, row,
              dtype=str(want.dtype).split(".")[-1], tensor=name)
    record["gn_autograd_check"] = row
    log(f"  GroupNormSiLU autograd on the card vs the CPU twin {GN_AUTOGRAD_SHAPE}: "
        f"{row['err_over_tol']:.3f} of tol")


GN_AUTOGRAD_SHAPE = (1, 320, 64, 64, 32, 1e-5, "bfloat16", True)


# name, check function, timed shapes, check-only shapes, source, TPU kernel replaced
KERNELS = (
    ("flash_sdpa", check_flash, FLASH_SHAPES, FLASH_EXTRA,
     "freefine_tpu_torch/csrc/flash_sdpa.cu", "freefine_tpu/ops/flash_attention.py:80"),
    ("tca_flash", check_tca, TCA_SHAPES, TCA_EXTRA,
     "freefine_tpu_torch/csrc/tca_flash.cu", "freefine_tpu/ops/flash_attention.py:175"),
    ("flash_sdpa_fwd_lse", check_grad, GRAD_SHAPES, GRAD_EXTRA,
     "freefine_tpu_torch/csrc/flash_sdpa.cu", "freefine_tpu/ops/flash_attention.py:307"),
    ("flash_sdpa_bwd_dq", check_grad, GRAD_SHAPES, GRAD_EXTRA,
     "freefine_tpu_torch/csrc/flash_sdpa_bwd.cu", "freefine_tpu/ops/flash_attention.py:344"),
    ("flash_sdpa_bwd_dkv", check_grad, GRAD_SHAPES, GRAD_EXTRA,
     "freefine_tpu_torch/csrc/flash_sdpa_bwd.cu", "freefine_tpu/ops/flash_attention.py:378"),
    ("tca_flash_fwd_lse", check_tca_grad, TCA_EDIT_SHAPES, TCA_GRAD_EXTRA,
     "freefine_tpu_torch/csrc/tca_flash.cu", "freefine_tpu/ops/flash_attention.py:569"),
    ("tca_flash_bwd_dq", check_tca_grad, TCA_EDIT_SHAPES, TCA_GRAD_EXTRA,
     "freefine_tpu_torch/csrc/tca_flash_bwd.cu", "freefine_tpu/ops/flash_attention.py:636"),
    ("tca_flash_bwd_dkv", check_tca_grad, TCA_EDIT_SHAPES, TCA_GRAD_EXTRA,
     "freefine_tpu_torch/csrc/tca_flash_bwd.cu", "freefine_tpu/ops/flash_attention.py:696"),
    ("group_norm_silu", check_gn, None, GN_EXTRA,
     "freefine_tpu_torch/csrc/group_norm.cu", "freefine_tpu/ops/group_norm.py:86"),
)


# check functions that hold several kernels at once ({kernel name: row})
MULTI_KERNEL_CHECKS = (check_grad, check_tca_grad)


def _log_row(name, r, timed):
    shape = r["key"] if "key" in r else ()
    msg = (f"  {name} {shape}{'' if timed else ' (check only)'}: err {r['max_abs_err']:.3g} "
           f"(max|ref| {r['max_ref']:.3g}, rel {r['rel_err']:.3g}, "
           f"{r['err_over_tol']:.3f} of tol)")
    if timed:
        lib = r["library_ms"]
        msg += (f"; dropped tile {r['dropped_tile_err_over_tol']:.3g} of tol; kernel "
                f"{r['kernel_ms']:.4f} ms plain {r['plain_ms']:.4f} ms library "
                f"{'-' if lib is None else f'{lib:.4f}'} ms bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}, {r['bound_ms'] / r['kernel_ms']:.3f} of the kernel's time)")
        if "kernel_graph_ms" in r:
            glib = r["library_graph_ms"]
            msg += (f"; in CUDA graphs kernel {r['kernel_graph_ms']:.4f} ms library "
                    f"{'-' if glib is None else f'{glib:.4f}'} ms")
    if "route" in r:
        msg += f"; route {r['route']}"
    if name == "group_norm_silu" and timed:
        msg += (f"; eager {r['kernel_eager_ms']:.4f} ms (the times above in CUDA graphs; "
                "launches per call counted last)")
    log(msg)
    for name, lay in r.get("layouts", {}).items():
        work = (f"{lay['passes_per_row']:.3f} live passes a row" if "passes_per_row" in lay
                else f"{lay['exps_per_pair']:.3f} exponentials a (query, key)")
        msg = (f"    masks {name}: {lay['err_over_tol']:.3f} of tol, "
               f"{lay['dead_pass_tile_share']:.3f} of the 64-row tiles with a dead pass, {work}")
        if "kernel_ms" in lay:
            if "swapped_pass_err_over_tol" in lay:
                msg += f"; swapped pass {lay['swapped_pass_err_over_tol']:.3g} of tol"
            msg += (f"; kernel {lay['kernel_ms']:.4f} ms, in CUDA graphs "
                    f"{lay['kernel_graph_ms']:.4f} ms; live bound {lay['bound_ms']:.4f} ms "
                    f"({lay['bound_ms'] / lay['kernel_graph_ms']:.3f} of the graph time), "
                    f"three-pass bound {lay['three_pass_bound_ms']:.4f} ms "
                    f"({lay['three_pass_bound_ms'] / lay['kernel_graph_ms']:.3f})")
        log(msg)


def phase_kernels(record):
    """Every kernel at every path shape (timed; SD-1.5's and phase
    G-XL's) and every extra case: {name: (rows, checks)}."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {name: ([], []) for name, *_ in KERNELS}
    done = set()
    for name, fn, shapes, extra, *_ in KERNELS:
        if fn in done:
            continue
        done.add(fn)
        if shapes is None:
            shapes = path_gn_shapes()
        for timed, group in ((True, shapes), (False, extra)):
            for shape in group:
                rows = fn(gen, shape, timed)
                for kname, r in (rows.items() if fn in MULTI_KERNEL_CHECKS else ((name, rows),)):
                    out[kname][0 if timed else 1].append(r)
                    _log_row(kname, r, timed)
    check_autograd(record)
    check_tca_autograd(record)
    check_gn_autograd(record)
    out["flash_sdpa"][1].extend(check_shared_kv(record))
    check_gd_autograd(record)
    return out


TIMES = ("kernel_ms", "plain_ms", "bound_ms", "library_ms", "bytes_ms", "ops_ms",
         "f32_route_ms", "kernel_graph_ms", "library_graph_ms", "three_pass_bound_ms")


def summarize(name, source, replaces, rows, checks, counts_by_path):
    """One kernel's entry of the `kernels` line.  For each path (phase 4
    `generation` with the fused GroupNorm, phase 5 `guided`, phase 6
    `bggen`, phase 7 `compose`, phase 8 `D`, one differentiated TCA pass,
    phase 9 `S` and `B`, one call of each batched lane with the fused
    GroupNorm, phase G-XL `XL`, one SDXL edit, phase PX `PX`, one PixArt
    edit; and for `group_norm_silu` phase 9b's E_gn_default and
    D_gn_default) the per-edit times weight each
    timed shape by the launches counted at that shape in one edit of that path
    (`counts_by_path`: {path: launch shapes of one edit}); the top-level
    launches and times are one edit of each path together. Without the edits
    (--skip-sd15) they are null."""
    timed = {r["key"]: r for r in rows}
    paths = None
    if counts_by_path is not None:
        paths, launched = {}, set()
        for path, counts in counts_by_path.items():
            counted = {key[1:]: n for key, n in counts.items() if key[0] == name}
            if set(counted) - set(timed):
                raise AssertionError(f"{name}: shapes launched in the {path} edit "
                                     f"{sorted(set(counted) - set(timed))} are not timed")
            launched |= set(counted)
            entry = dict(launches=sum(counted.values()))
            # a row timed at several mask layouts: the one this path passes
            at = {key: timed[key].get("layouts", {}).get(TCA_PATH_LAYOUT.get(path), timed[key])
                  for key in counted}
            for field in (f for f in TIMES if f in rows[0]):
                vals = [at[key][field] for key in counted]
                entry[field.replace("kernel_ms", "ms")] = (
                    None if any(x is None for x in vals)
                    else sum(at[key][field] * n for key, n in counted.items()))
            paths[path] = entry
            for key, n in counted.items():
                timed[key].setdefault("launches", {})[path] = n
        unused = set(timed) - launched - NOT_ON_A_PATH
        if unused:
            raise AssertionError(f"{name}: shapes timed but launched on no path: "
                                 f"{sorted(unused)}")

    def total(field):
        if paths is None or any(p[field] is None for p in paths.values()):
            return None
        return sum(p[field] for p in paths.values())

    both = rows + checks
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=total("launches"),
        max_abs_err=max(r["max_abs_err"] for r in both),
        max_rel_err=max(r["rel_err"] for r in both),
        err_over_tol=max(r["err_over_tol"] for r in both),
        tol=dict(zip(("max_abs_err_of_max_ref", "rel_err"),
                     LIMITS.get(name, (ABS_OF_MAX, REL_TOL)))),
        ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
        bound_by=None if paths is None else (
            "operations" if total("ops_ms") >= total("bytes_ms") else "bytes"),
        library_ms=total("library_ms"),
        library_call=next((r["library_call"] for r in rows if "library_call" in r),
                          None if rows[0]["library_ms"] is None
                          else "F.scaled_dot_product_attention"),
        f32_route_ms=total("f32_route_ms") if "f32_route_ms" in rows[0] else None,
        per=("one edit of each path (D: one differentiated pass; S and B: one batched call of "
             f"{BATCH_SHARED} and {BATCH_CASES} edits; XL: one SDXL 1024^2 edit; PX: one PixArt "
             "512^2 edit; 3D: one depth-based 3D edit, EfficientSAM's box mask and "
             "Depth-Anything's depth included, its TCA launches weighted at G's edit masks; SV3D: one "
             "SV3D coarse 3D edit (the 21-frame orbit, its VAE calls) and the generation that "
             "refines it, TCA weighted at G's edit masks; DIFT: one DIFT featurisation of "
             "a 512^2 image (ensemble 8); MG: one MotionGuidance edit of "
             f"{MG_STEPS * MG_RECURSIVE} energy gradients, GroupNorm default; RD, DE, SG, GD: "
             "one RegionDrag drag_regions, DesignEdit move, SelfGuidance edit and GeoDiffuser "
             "edit at GeoBench's 50-step protocol (SG and GD cut to "
             f"{GRADIENT_BASELINE_STEPS} steps), GroupNorm default; DH: one "
             "DiffusionHandles edit at GeoBench's 50 steps cut to 2 null-text and 1 guided "
             "gradient steps a step (100 and 38 gradients; the protocol's 500 and 114) with "
             "its Depth-Anything depth call; DD: one DragDiffusion drag cut to 20 LoRA steps "
             "and at most 20 drag iterations (the protocol's 80 and 80), the MasaCtrl "
             "denoise, GroupNorm default; EV: one metrics.main call at every metric but MD "
             f"({EV_IMAGES * EV_CASES} edits, {EV_REAL} real images); "
             "group_norm_silu also E_gn_default and D_gn_default, phase 9b's "
             "guided edit and differentiated pass under the default) together; per path under "
             "`paths`"),
        paths=paths, shapes=rows, checks=checks,
    )


# ---------------------------------------------------------------------------
# Phases 3 to 7: the pipeline
# ---------------------------------------------------------------------------

# final latents, and the TCA pass's latent gradient (times max |ref|), CUDA
# vs CPU, float32 with TF32 off: summation order only
TINY_TOL = 2e-3


def _case(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    mask = np.zeros((h, w), np.uint8)
    mask[h // 4 : h // 2, w // 4 : w // 2] = 255
    return img, mask


def edit_case(cfg, device="cuda"):
    """The edit of phases 4 to 8: (image, object mask, coarse edit, target
    mask) at the config's resolution, the object moved, rotated and scaled
    by `re_edit_2d`."""
    from freefine_tpu_torch.ops.geometry import re_edit_2d

    img, mask = _case(cfg.height, cfg.width, 3)
    coarse, tm, _ = re_edit_2d(img, mask, dx=40, dy=-20, rotation=10, scale_x=1.1,
                               scale_y=1.1, device=device)
    return img, mask, coarse, tm


@functools.lru_cache(maxsize=None)
def batch_cases(n: int, device: str = "cuda") -> tuple:
    """The cases of phase 9, as `BatchedFreeFine` takes them: phase 4's
    source image and object, case i's coarse edit the object moved by
    (40 - 6i, -20 + 3i), rotated by 10 - i degrees and scaled by 1.1
    (`re_edit_2d`), so case 0 is phase 4's edit and every case has its own
    masks."""
    from freefine_tpu_torch.config import sd15_pipeline_config
    from freefine_tpu_torch.ops.geometry import re_edit_2d

    cfg = sd15_pipeline_config()
    img, mask = _case(cfg.height, cfg.width, 3)
    cases = []
    for i in range(n):
        coarse, tm, _ = re_edit_2d(img, mask, dx=40 - 6 * i, dy=-20 + 3 * i, rotation=10 - i,
                                   scale_x=1.1, scale_y=1.1, device=device)
        cases.append(dict(ori_img=img, ori_mask=mask, coarse_input=coarse, target_mask=tm,
                          guidance_text="a photo of a cat" if i == 0 else f"a photo of cat {i}"))
    return tuple(cases)


def _capture_latents(pipe, store):
    orig = pipe.latent_to_image

    def cap(lat):
        store["lat"] = lat.detach().float().cpu()
        return orig(lat)

    pipe.latent_to_image = cap


@contextlib.contextmanager
def fused_gn(mode):
    """FREEFINE_FUSED_GN set to `mode` (None: unset, the default "auto")
    inside the block, restored after."""
    prev = os.environ.get("FREEFINE_FUSED_GN")
    if mode is None:
        os.environ.pop("FREEFINE_FUSED_GN", None)
    else:
        os.environ["FREEFINE_FUSED_GN"] = mode
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("FREEFINE_FUSED_GN", None)
        else:
            os.environ["FREEFINE_FUSED_GN"] = prev


# the tiny configs of phase 3: (config maker in `freefine_tpu_torch.config`,
# log label); "xl" runs `SDXLFreeFine`, the others `FreeFine`
TINY_MODELS = {"sd15": ("tiny_pipeline_config", ""), "xl": ("tiny_sdxl_pipeline_config", " SDXL"),
               "dit": ("tiny_dit_pipeline_config", " DiT"),
               "pixart": ("tiny_pixart_pipeline_config", " PixArt")}


def phase_tiny(record, model="sd15"):
    """The entry points on the tiny config, CUDA against the CPU with the
    same weights and noise: `generation` (fused GroupNorm off and on),
    `guided_generation`, and with the fused GroupNorm
    `background_generation` and `cross_image_composition` of 2 sources;
    and with FREEFINE_FUSED_GN unset `generation` at GeoBench-3D's protocol
    on a coarse 3D edit (`re_edit_3d_depth` of a depth plane).
    With model "xl", `SDXLFreeFine` on the tiny SDXL config: the four entry
    points and the batched `generation` and `generation_shared_source`
    lanes; with "dit" and "pixart", `FreeFine` on the tiny DiT and PixArt
    configs: the three entry points the DiT runs and the same lanes; each
    with FREEFINE_FUSED_GN unset (the kernel on the card, the two-pass math
    on the CPU), into record["tiny_<model>"].  On the SD-1.5 and DiT
    configs, one denoiser forward with IP-Adapter tokens (`tiny_ip`); the
    tiny PixArt config's denoiser is the tiny DiT's, so its forward would
    repeat that one."""
    import torch

    from freefine_tpu_torch import config as C
    from freefine_tpu_torch import pipeline as P
    from freefine_tpu_torch import sdxl
    from freefine_tpu_torch.ops.geometry import re_edit_2d
    from freefine_tpu_torch.ops.point_splat import re_edit_3d_depth

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    make, label = TINY_MODELS[model]
    cfg = getattr(C, make)()
    cls = sdxl.SDXLFreeFine if model == "xl" else P.FreeFine
    cpu = cls(cfg, init_random=True, seed=0, device="cpu")
    gpu = cls(cfg, params={n: m.state_dict() for n, m in cpu.components().items()},
              device="cuda")
    h, w = cfg.height, cfg.width
    img, mask = _case(h, w, 1)
    coarse_c, tm_c, _ = re_edit_2d(img, mask, dx=10, rotation=15, device="cpu")
    coarse_g, tm_g, _ = re_edit_2d(img, mask, dx=10, rotation=15, device="cuda")
    assert np.abs(coarse_c.astype(int) - coarse_g.astype(int)).max() <= 1
    assert np.array_equal(tm_c, tm_g)
    rng = np.random.default_rng(2)
    src2, _ = _case(h, w, 4)
    mask2 = np.zeros((h, w), np.uint8)
    mask2[h // 2 :, w // 2 :] = 255
    cons = np.zeros((h, w), np.uint8)
    edit_kw = dict(num_step=8, start_step=4, end_step=1)
    # the 3D edit: the coarse edit of a synthetic depth plane, then
    # GeoBench-3D's protocol (start 3 of 8, TCA to the end, no auto draw)
    plane = 5.0 + np.linspace(0, 1.5, w, dtype=np.float32)[None, :].repeat(h, 0)
    coarse3, tm3, _ = re_edit_3d_depth(img, mask, plane, (0, 0, 0, 0, 20, 0, 1, 1, 1),
                                       focal_length_x=0.92 * w, focal_length_y=0.92 * w,
                                       device="cpu")
    kw_3d = dict(num_step=8, start_step=3, end_step=8, end_scale=0.0, draw_mask=tm3,
                 use_auto_draw=False, cons_area=tm3, reduce_inp_artifacts=True)
    # name: (GroupNorm mode, per-step noise rows, steps, call)
    runs = {
        "generation": ("0", 2, 4, lambda p, **kw: p.generation(
            img, mask, coarse_c, tm_c, "a photo", use_auto_draw=True, cons_area=cons,
            reduce_inp_artifacts=True, **edit_kw, **kw)),
        "generation_fused_gn": ("1", 2, 4, lambda p, **kw: p.generation(
            img, mask, coarse_c, tm_c, "a photo", use_auto_draw=True, cons_area=cons,
            reduce_inp_artifacts=True, **edit_kw, **kw)),
        "guided_generation": ("0", 2, 4, lambda p, **kw: p.guided_generation(
            img, mask, coarse_c, tm_c, "a photo", energy_fraction=0.5, cons_area=cons,
            **edit_kw, **kw)),
        "guided_generation_gn_default": (None, 2, 4, lambda p, **kw: p.guided_generation(
            img, mask, coarse_c, tm_c, "a photo", energy_fraction=0.5, cons_area=cons,
            **edit_kw, **kw)),
        "background_generation": ("1", 2, 5, lambda p, **kw: p.background_generation(
            img, mask, "a wall", num_step=6, start_step=1, end_step=3, **kw)),
        "cross_image_composition": ("1", 1, 4, lambda p, **kw: p.cross_image_composition(
            [img, src2], [mask, mask2], [tm_c, mask2], coarse_c, ["a cat", "a dog"],
            dil_factor=5, **edit_kw, **kw)),
        "generation_3d": (None, 2, 5, lambda p, **kw: p.generation(
            img, mask, coarse3, tm3, "a photo", **kw_3d, **kw)),
    }
    if model != "sd15":  # the DiT has no feature taps for the energy
        keep = ("generation", "background_generation", "cross_image_composition") + (
            ("guided_generation",) if model == "xl" else ())
        runs = {entry: (None, *run[1:]) for entry, run in runs.items() if entry in keep}
    stores = {name: {} for name in ("cpu", "cuda")}
    for name, pipe in (("cpu", cpu), ("cuda", gpu)):
        _capture_latents(pipe, stores[name])
    out = record["tiny" if model == "sd15" else f"tiny_{model}"] = {}
    for entry, (mode, rows, k, call) in runs.items():
        noise = [rng.standard_normal((rows, cfg.latent_height, cfg.latent_width, 4))
                 .astype(np.float32) for _ in range(k)]
        lats, outs = {}, {}
        with fused_gn(mode):
            for name, pipe in (("cpu", cpu), ("cuda", gpu)):
                outs[name] = call(pipe, noise=[torch.from_numpy(z).to(name) for z in noise])
                lats[name] = stores[name]["lat"]
        err = float((lats["cpu"] - lats["cuda"]).abs().max())
        img_err = int(np.abs(outs["cpu"].astype(int) - outs["cuda"].astype(int)).max())
        out[entry] = dict(latent_max_abs_err=err, latent_tol=TINY_TOL,
                          image_max_level_diff=img_err, fused_gn=mode or "unset",
                          finite=bool(torch.isfinite(lats["cuda"]).all()))
        log(f"  tiny{label} {entry} CUDA vs CPU: latents max |diff| {err:.3g} "
            f"(tol {TINY_TOL}), image {img_err} levels")
        if not err <= TINY_TOL or img_err > 1 or not out[entry]["finite"]:
            raise AssertionError(f"tiny {entry}: CUDA and CPU disagree: {out[entry]}")
    tiny_batched(out, cpu, gpu, stores, img, mask, edit_kw, model)
    if model in ("sd15", "dit"):
        tiny_ip(out, cpu, gpu, label)
    if model != "sd15":
        return
    for mode in ("0", None):
        with fused_gn(mode):
            tiny_tca_grad(record, cpu, gpu, img, mask, coarse_c, tm_c)


def tiny_ip(results, cpu, gpu, label):
    """One denoiser forward with IP-Adapter tokens at ip_scale 0.5, CUDA
    against the CPU: `add_ip_adapter` on the CPU pipe, its weights copied
    to the CUDA pipe's; the image tokens must move the output by far more
    than the two sides differ.  Into `results["ip_forward"]`."""
    import torch

    from freefine_tpu_torch.edit import EditConfig
    from freefine_tpu_torch.models.ip_adapter import add_ip_adapter

    add_ip_adapter(cpu, seed=5)
    add_ip_adapter(gpu)
    gpu.unet.load_state_dict(cpu.unet.state_dict())
    cfg = cpu.config
    width = cfg.unet.cross_attention_dim
    rng = np.random.default_rng(11)
    lat, ctx, tok = (rng.standard_normal(shape).astype(np.float32) for shape in (
        (2, 4, cfg.latent_height, cfg.latent_width), (2, 77, width), (2, 16, width)))
    ecfg = EditConfig(mode="none", method=None, local_cfg=False, ip_scale=0.5)
    outs = {}
    with torch.no_grad():
        for name, pipe in (("cpu", cpu), ("cuda", gpu)):
            x, c, t = (torch.from_numpy(a).to(name) for a in (lat, ctx, tok))
            outs[name] = pipe.unet(x, 501, c, edit_cfg=ecfg, context_image=t).float().cpu()
        plain = gpu.unet(x, 501, c).float().cpu()
    err = float((outs["cpu"] - outs["cuda"]).abs().max())
    effect = float((outs["cuda"] - plain).abs().max())
    rec = results["ip_forward"] = dict(max_abs_err=err, tol=TINY_TOL, ip_effect=effect,
                                       ip_scale=0.5, finite=bool(outs["cuda"].isfinite().all()))
    log(f"  tiny{label} denoiser forward with IP tokens (ip_scale 0.5) CUDA vs CPU: max |diff| "
        f"{err:.3g} (tol {TINY_TOL}); the tokens move the output by {effect:.3g}")
    if not (err <= TINY_TOL and effect > 100 * err and effect > 1e-5 and rec["finite"]):
        raise AssertionError(f"tiny{label} IP forward: {rec}")


def tiny_batched(results, cpu, gpu, stores, img, mask, edit_kw, model="sd15"):
    """Phase 3's batched lanes: `BatchedFreeFine.generation` and
    `generation_shared_source` (2 cases, TCA) and, with the fused
    GroupNorm, `background_generation_shared_source` (2 removal cases), on
    CUDA against the CPU with the same weights and per-case noise; launches
    of the CUDA call against the counts worked out from the config, and the
    per-case lane at 3 cases launching exactly what it launches at 2.  On
    the SDXL, DiT and PixArt configs, the two edit lanes, FREEFINE_FUSED_GN
    unset.  Into `results`."""
    import torch

    from freefine_tpu_torch.ops import flash_attention as FA
    from freefine_tpu_torch.ops import group_norm as G
    from freefine_tpu_torch.ops.geometry import re_edit_2d
    from freefine_tpu_torch.pipeline import BatchedFreeFine

    cfg = cpu.config
    h, w, lh, lw = cfg.height, cfg.width, cfg.latent_height, cfg.latent_width
    cases, removals = [], []
    for i, (dx, dy, rot) in enumerate(((10, 0, 15), (-6, 4, -10), (3, -5, 5))):
        coarse, tm, _ = re_edit_2d(img, mask, dx=dx, dy=dy, rotation=rot, device="cpu")
        cases.append(dict(ori_img=img, ori_mask=mask, coarse_input=coarse, target_mask=tm,
                          guidance_text=f"a photo {i}"))
        removals.append(dict(ori_img=img, ori_mask=tm, guidance_text=f"a wall {i}"))
    k_edit, k_bg = edit_kw["num_step"] - edit_kw["start_step"], 5
    bg_kw = dict(num_step=6, start_step=1, end_step=3)
    # name: (GroupNorm mode, steps, inversion and capture passes, call)
    runs = {
        "batched_generation": ("0", k_edit, k_edit, lambda p, c, **kw: BatchedFreeFine(
            p).generation(c, **edit_kw, **kw)),
        "batched_generation_shared_source": ("0", k_edit, 3 * k_edit, lambda p, c, **kw:
            BatchedFreeFine(p).generation_shared_source(c, **edit_kw, **kw)),
        "batched_background_generation_shared_source": ("1", k_bg, 2 * k_bg, lambda p, c, **kw:
            BatchedFreeFine(p).background_generation_shared_source(
                [removals[i] for i in range(len(c))], **bg_kw, **kw)),
    }
    if model != "sd15":
        runs = {entry: (None, *run[1:]) for entry, run in runs.items()
                if entry != "batched_background_generation_shared_source"}
    rng = np.random.default_rng(3)
    for entry, (mode, k, k_inv, call) in runs.items():
        noise = [[rng.standard_normal((2, lh, lw, 4)).astype(np.float32) for _ in range(k)]
                 for _ in range(3)]
        lats, outs, launched = {}, {}, {}
        with fused_gn(mode):
            for n, name, pipe in ((2, "cpu", cpu), (2, "cuda", gpu), (3, "cuda", gpu)):
                if n == 3 and entry != "batched_generation":
                    continue
                FA.reset_launch_counts()
                G.reset_launch_counts()
                out = call(pipe, cases[:n], noise=[[torch.from_numpy(z).to(name) for z in zs]
                                                   for zs in noise[:n]])
                if n == 2:
                    outs[name], lats[name] = out, stores[name]["lat"]
                if name == "cuda":
                    launched[n] = _launch_counts()[0]
        err = float((lats["cpu"] - lats["cuda"]).abs().max())
        img_err = max(int(np.abs(a.astype(int) - b.astype(int)).max())
                      for a, b in zip(outs["cpu"], outs["cuda"]))
        expect = _expected(cfg, gpu, k_inv, k, fused=mode == "1")
        rec = results[entry] = dict(
            latent_max_abs_err=err, latent_tol=TINY_TOL, image_max_level_diff=img_err,
            fused_gn=mode, cases=2, finite=bool(torch.isfinite(lats["cuda"]).all()),
            launches=launched[2], launches_at_3_cases=launched.get(3))
        log(f"  tiny{TINY_MODELS[model][1]} {entry} (2 cases) CUDA vs CPU: latents max |diff| "
            f"{err:.3g} (tol {TINY_TOL}), images {img_err} levels; launches by cases "
            f"{ {n: {k: v for k, v in c.items() if v} for n, c in launched.items()} }")
        if not err <= TINY_TOL or img_err > 1 or not rec["finite"]:
            raise AssertionError(f"tiny {entry}: CUDA and CPU disagree: {rec}")
        for kname in ("flash_sdpa", "tca_flash"):
            if launched[2][kname] != expect[kname]:
                raise AssertionError(f"tiny {entry}: {kname} launched {launched[2][kname]} "
                                     f"times, expected {expect[kname]}")
        if 3 in launched and launched[3] != launched[2]:
            raise AssertionError(f"tiny {entry}: launches grow with the cases: {launched}")


def tca_pass_inputs(pipe, case, mode, start_step, num_step=50, end_step=10):
    """The inputs of one regeneration UNet pass over [u_e, r, c_e], built as
    `generation` (mode "edit") or `background_generation` ("bggen") builds
    them: the edit and reference latents (the coarse edit and the source;
    bggen the source for both), the masks and their pyramids, the TCA
    schedule's first step (context guidance, share gate, with `end_step`
    as the entry points take it), the timestep at
    `start_step` and the [u, u, cond] text embeddings.
    -> (latents [2, lh, lw, 4] f32, t, text_emb, ecfg, state)."""
    import torch

    from freefine_tpu_torch import masks as mask_ops
    from freefine_tpu_torch.edit import EditConfig, EditState, build_mask_pyramid
    from freefine_tpu_torch.schedulers.ddim import method_and_gates

    img, mask, coarse, tm = case
    cfg, dev = pipe.config, pipe.device
    lh, lw = cfg.latent_height, cfg.latent_width

    def t(x):
        return torch.as_tensor(np.asarray(x), device=dev)

    if mode == "edit":
        lat = pipe.image_to_latent(np.stack([pipe._prep_image(coarse), pipe._prep_image(img)]))
        em = mask_ops.prepare_various_mask(
            t(tm), t(mask), None, cfg.height, cfg.width, lh, lw, use_auto_draw=True,
            cons_area=t(np.zeros(mask.shape, np.uint8)), reduce_inp_artifacts=True)
        state = EditState(fg_retain=build_mask_pyramid(em.fg_retain, lh, lw),
                          fg_ref=build_mask_pyramid(em.fg_ref, lh, lw),
                          local_region=build_mask_pyramid(em.fg_retain, lh, lw))
    else:
        lat = pipe.image_to_latent(pipe._prep_image(img)).repeat(2, 1, 1, 1)
        full, _ = mask_ops.prepare_mask_bggen(t(mask), cfg.height, cfg.width, lh, lw)
        pyr = build_mask_pyramid(full, lh, lw)
        state = EditState(fg_retain=pyr, fg_ref=pyr, local_region=pyr)
    method, cg, gates = method_and_gates("tca", start_step, end_step, num_step, 0.5)
    state.context_guidance, state.share_gate = float(cg[0]), float(gates[0])
    ecfg = EditConfig(mode=mode, method=method, local_cfg=True, layer_range=pipe._layer_range)
    ts = int(pipe._schedule(num_step).timesteps[start_step])
    return lat, ts, pipe._edit_text_embeddings("a photo of a cat"), ecfg, state


def tca_grad_pass(pipe, inputs, w):
    """One differentiated TCA UNet pass: eps over [u_e, r, c_e] with the
    edit latent requiring grad, loss = <eps of the edit streams u_e and
    c_e, w>, backward to the edit latent.  -> (loss, gradient [1, lh, lw, 4])."""
    import torch

    lat, t, emb, ecfg, state = inputs
    x = lat[:1].detach().clone().requires_grad_()
    eps = pipe.unet_apply(torch.cat([x, lat[1:], x]), t, emb, ecfg, state)
    loss = (eps[[0, 2]].float() * w).sum()
    return loss.detach(), torch.autograd.grad(loss, x)[0]


def tiny_tca_grad(record, cpu, gpu, img, mask, coarse, tm):
    """Phase 3's gradient check: the latent gradient of one differentiated
    TCA UNet pass (modes edit and bggen) on CUDA against the CPU, the same
    inputs (built on the CPU) and cotangent, under the FREEFINE_FUSED_GN
    the caller set (unset: recorded with the suffix "_gn_default")."""
    import torch

    from freefine_tpu_torch.ops import flash_attention as FA
    from freefine_tpu_torch.ops import group_norm as G

    cfg = cpu.config
    w = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, cfg.latent_height, cfg.latent_width, 4)).astype(np.float32))
    sfx = "" if "FREEFINE_FUSED_GN" in os.environ else "_gn_default"
    for mode in ("edit", "bggen"):
        # phase 3's schedule (8 steps, start 4, end 1): context guidance 0.29,
        # so all three passes carry weight
        lat, t, emb, ecfg, state = tca_pass_inputs(cpu, (img, mask, coarse, tm), mode, 4, 8, 1)
        _, want = tca_grad_pass(cpu, (lat, t, emb, ecfg, state), w)
        FA.reset_launch_counts()
        G.reset_launch_counts()
        _, got = tca_grad_pass(gpu, (lat.cuda(), t, emb.map(lambda a: a.cuda()), ecfg, state),
                               w.cuda())
        launched = {k: FA.LAUNCHES[k] for k in TCA_GRAD_KERNELS}
        if sfx:  # the default fuses on the card
            launched.update(G.LAUNCHES)
        err = float((got.cpu() - want).abs().max())
        ref = float(want.abs().max())
        rec = dict(grad_max_abs_err=err, grad_max_ref=ref, tol=TINY_TOL * ref,
                   finite=bool(torch.isfinite(got).all()), tca_vjp_launches=launched)
        record["tiny"][f"tca_grad_{mode}{sfx}"] = rec
        log(f"  tiny TCA gradient ({mode}{sfx}) CUDA vs CPU: max |diff| {err:.3g} "
            f"(tol {TINY_TOL} x max|ref| {ref:.3g}), TCA VJP launches {launched}")
        if not (err <= TINY_TOL * ref and ref > 0 and rec["finite"]) or 0 in launched.values():
            raise AssertionError(f"tiny TCA gradient ({mode}{sfx}): {rec}")


# Kernel names of a GroupNorm in a profile: the port's kernels (namespace
# gn), and the kernels of PyTorch's F.group_norm (statistics, coefficients,
# normalise); the f32 route's casts and SiLU run as generic elementwise
# kernels and are not counted.
GN_KERNEL_NAMES = ("gn::gn_", "RowwiseMoments", "ComputeFusedParams",
                   "GroupNormKernelImplInternal")


def profile_edit(run, out_name):
    """One edit under torch.profiler: device time by kernel name, device
    busy share of the edit's wall time; the table goes to
    chiprun_out/<out_name>."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only: an aten op's own entry repeats its kernels' time
    kernels = [e for e in events
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    rows = sorted(((e.key, dev_us(e), e.count) for e in kernels if dev_us(e) > 0),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", out_name), "w") as f:
        f.write(f"wall {wall:.4f} s, device busy {busy:.4f} s\n")
        for name, us, n in rows:
            f.write(f"{us / 1e3:12.3f} ms {n:8d}  {name}\n")
    top = [dict(name=n[:120], ms=us / 1e3, count=c) for n, us, c in rows[:25]]
    gn_ms = sum(us for name, us, _ in rows if any(p in name for p in GN_KERNEL_NAMES)) / 1e3
    transposes_ms = sum(us for name, us, _ in rows
                        if "nchwToNhwc" in name or "nhwcToNchw" in name) / 1e3
    copies_ms = sum(us for name, us, _ in rows if "copy" in name.lower()) / 1e3
    log(f"  profiled edit: wall {wall:.3f} s, device busy {busy:.3f} s "
        f"(idle share {1 - busy / wall:.3f}); named GroupNorm kernels {gn_ms:.2f} ms, "
        f"cuDNN layout transposes {transposes_ms:.2f} ms, copy kernels {copies_ms:.2f} ms")
    for r in top[:12]:
        log(f"    {r['ms']:10.2f} ms {r['count']:6d}  {r['name']}")
    return dict(wall_s=wall, device_busy_s=busy, idle_share=1 - busy / wall, top=top,
                group_norm_kernels_ms=gn_ms, group_norm_kernel_names=GN_KERNEL_NAMES,
                layout_transposes_ms=transposes_ms, copies_ms=copies_ms)


def _launch_counts():
    from freefine_tpu_torch.ops import flash_attention as FA
    from freefine_tpu_torch.ops import group_norm as G

    return {**FA.LAUNCHES, **G.LAUNCHES}, {**FA.LAUNCH_SHAPES, **G.LAUNCH_SHAPES}


def edit_once(key, run, expect, store, hw, cases=1):
    """One timed edit (a batched call of `cases` edits: a list of images);
    the launch counters are set to 0 just before it and read just after,
    and must equal `expect`.  The output is left in store["out"].
    -> (seconds, launches by shape)."""
    import torch

    out, secs, shapes = counted(key, run, expect)
    outs = out if isinstance(out, list) else [out]
    if len(outs) != cases or any(o.shape != (*hw, 3) or o.dtype != np.uint8 for o in outs):
        raise AssertionError(f"{key}: output {[(o.shape, o.dtype) for o in outs]}")
    if not torch.isfinite(store["lat"]).all():
        raise AssertionError(f"{key}: non-finite final latents")
    store["out"] = out
    return secs, shapes


def _edit_record(record, key, secs, shapes, expect, peak, card, cases=1):
    record[key] = dict(
        seconds_per_edit=[t / cases for t in secs],
        edits_per_min=60.0 * cases / float(np.mean(secs)),
        peak_memory_bytes=peak, launches=expect, expected_launches=expect,
        launches_by_shape=[[*k, n] for k, n in sorted(shapes.items())],
    )
    if cases > 1:
        record[key].update(cases_per_call=cases, seconds_per_call=secs)
    log(f"  {key}: {record[key]['edits_per_min']:.3f} edits/min, s/edit "
        f"{record[key]['seconds_per_edit']}"
        + (f" (s per call of {cases} {secs})" if cases > 1 else "")
        + f", peak {peak / 2**30:.2f} GiB, launches {expect} [{card}]")


def timed_edits(record, key, run, expect, timed_runs, store, hw, cases=1):
    """One warm-up and `timed_runs` timed edits (or batched calls of
    `cases` edits) of one path (`edit_once` each).  Returns the launches of
    one edit (call) by call shape."""
    import torch

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    record[f"{key}_warmup_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    secs, first_shapes = [], None
    for _ in range(timed_runs):
        t, shapes = edit_once(key, run, expect, store, hw, cases)
        secs.append(t)
        if first_shapes is not None and shapes != first_shapes:
            raise AssertionError(f"{key}: launches by shape differ between edits: {shapes}")
        first_shapes = shapes
    _edit_record(record, key, secs, first_shapes, expect, torch.cuda.max_memory_allocated(),
                 record["card"], cases)
    return first_shapes


def sd15_setup(record):
    import torch

    from freefine_tpu_torch.config import sd15_pipeline_config
    from freefine_tpu_torch.pipeline import FreeFine

    cfg = sd15_pipeline_config()
    t0 = time.perf_counter()
    pipe = FreeFine(cfg, init_random=True, seed=0, device="cuda")
    torch.cuda.synchronize()
    record["sd15_setup_s"] = time.perf_counter() - t0
    store = {}
    _capture_latents(pipe, store)
    return pipe, edit_case(cfg), store


def _expected(cfg, pipe, k_inv, k_edit, energy_steps=0, feature_indices=(1, 2), *,
              mode="edit", encodes=1, decodes=1, fused=False):
    """Launches per edit worked out from the config: every self-attention
    of each inversion pass; the layers outside the TCA window of each
    regeneration pass, and inside it `tca_flash` (edit, bggen) or, in
    composition, the self-attention and the per-source masked attention;
    per energy step the no-grad reference-feature pass (`flash_sdpa`), the
    differentiated pass (forward with logsumexp) and two gradient pulls
    through the layers upstream of the deepest feature tap used (UNet
    only); one VAE attention per encode and decode call.  With the fused
    GroupNorm, every GroupNorm of every UNet pass and VAE call
    (`norm_calls`; a DiT pass has none).  A DiT's layers are its blocks."""
    u = cfg.unet
    n_layers, _ = u.attn_layer_layout
    lo, hi = pipe._layer_range
    gated = hi - lo
    upstream = 0
    if energy_steps:
        nb = len(u.block_out_channels)
        down = sum(u.transformer_depth[i] * u.layers_per_block for i in range(nb)
                   if u.down_block_has_attn[i])
        up = sum(u.transformer_depth[nb - 1 - i] * (u.layers_per_block + 1)
                 for i in range(max(feature_indices)) if u.up_block_has_attn[i])
        upstream = down + u.transformer_depth[nb - 1] + up
    compose = mode == "compose"
    unet_passes = k_inv + k_edit + 2 * energy_steps
    return {**{name: 0 for name in TCA_GRAD_KERNELS},
        "flash_sdpa": k_inv * n_layers + k_edit * (n_layers - gated)
        + (2 * k_edit * gated if compose else 0) + energy_steps * n_layers + encodes + decodes,
        "tca_flash": 0 if compose else k_edit * gated,
        "flash_sdpa_fwd_lse": energy_steps * n_layers,
        "flash_sdpa_bwd_dq": energy_steps * 2 * upstream,
        "flash_sdpa_bwd_dkv": energy_steps * 2 * upstream,
        "group_norm_silu": 0 if not fused else (
            unet_passes * len(norm_calls(cfg, "unet"))
            + encodes * len(norm_calls(cfg, "vae_encode"))
            + decodes * len(norm_calls(cfg, "vae_decode"))),
    }


def _expected_tca_grad(cfg, pipe):
    """Launches per differentiated TCA edit pass, worked out from the
    config: the TCA VJP kernels once per gated layer; forward with
    logsumexp, dQ and dK/dV once per layer outside the TCA window (the
    gradient reaches every layer); nothing else."""
    n_layers, _ = cfg.unet.attn_layer_layout
    lo, hi = pipe._layer_range
    expect = _expected(cfg, pipe, 0, 0, encodes=0, decodes=0)
    expect.update({name: hi - lo for name in TCA_GRAD_KERNELS})
    expect.update({name: n_layers - (hi - lo) for name in
                   ("flash_sdpa_fwd_lse", "flash_sdpa_bwd_dq", "flash_sdpa_bwd_dkv")})
    return expect


def phase_tca_grad(record, pipe, case, timed_runs=3):
    """Phase 8: the differentiated SD-1.5 TCA edit pass, built from phase
    4's case as `generation` builds its state (start step 35 of 50), the
    fused GroupNorm off.  One warm-up, then `timed_runs` passes, each with
    the launch counters set to 0 just before and read just after.
    Returns the launches of one pass by call shape."""
    import torch

    from freefine_tpu_torch.ops import flash_attention as FA
    from freefine_tpu_torch.ops import group_norm as G

    cfg = pipe.config
    inputs = tca_pass_inputs(pipe, case, "edit", 35)
    w = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, cfg.latent_height, cfg.latent_width, 4)).astype(np.float32)).cuda()
    expect = _expected_tca_grad(cfg, pipe)
    t0 = time.perf_counter()
    tca_grad_pass(pipe, inputs, w)
    torch.cuda.synchronize()
    record["sd15_tca_grad_warmup_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    secs, shapes, grads = [], None, []
    for _ in range(timed_runs):
        FA.reset_launch_counts()
        G.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grad = tca_grad_pass(pipe, inputs, w)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches, sh = _launch_counts()
        if launches != expect:
            raise AssertionError(f"TCA grad pass: launch counts {launches} != expected {expect}")
        if shapes is not None and sh != shapes:
            raise AssertionError(f"TCA grad pass: launches by shape differ between passes: {sh}")
        shapes = sh
        if not (torch.isfinite(grad).all() and grad.abs().max() > 0 and torch.isfinite(loss)):
            raise AssertionError("TCA grad pass: the latent gradient is not finite and non-zero")
        grads.append(grad)
    peak = torch.cuda.max_memory_allocated()
    record["sd15_tca_grad"] = dict(
        seconds_per_pass=secs, peak_memory_bytes=peak, launches=expect,
        launches_by_shape=[[*k, n] for k, n in sorted(shapes.items())],
        grad_max_abs=float(grads[-1].abs().max()), grad_norm=float(grads[-1].float().norm()),
        grad_spread_between_passes=float(max((g - grads[0]).abs().max() for g in grads)),
        loss=float(loss),
        protocol=("SD-1.5 512^2, one regeneration UNet pass in mode edit (TCA, layer range "
                  f"{pipe._layer_range}) over [u_e, r, c_e] at start step 35 of 50, bf16 random "
                  "weights, FREEFINE_FUSED_GN off; loss <eps of u_e and c_e, W>, W seeded; "
                  "gradient to the edit latent; host clock around forward + backward"))
    log(f"  TCA grad pass: s/pass {secs}, peak {peak / 2**30:.2f} GiB, |grad| max "
        f"{record['sd15_tca_grad']['grad_max_abs']:.3g}, launches {expect} [{record['card']}]")
    return shapes


def phase_sd15(record, pipe, case, store, timed_runs, profile):
    """The full-width `generation` edit (GeoBench-2D protocol), with the
    fused GroupNorm off ("0") and on ("1") in turns: one warm-up of each,
    then 0, 1, 1, 0 (timed_runs edits of each).  Returns the launches by
    shape of the fused edit."""
    import torch

    img, mask, coarse, tm = case
    h, w = pipe.config.height, pipe.config.width
    num_step, start_step = 50, 35
    kw = dict(guidance_scale=7.5, eta=1.0, num_step=num_step, start_step=start_step,
              end_step=10, method_type="tca", use_auto_draw=True,
              cons_area=np.zeros((h, w), np.uint8), reduce_inp_artifacts=True, seed=42)
    k = num_step - start_step

    def run():
        return pipe.generation(img, mask, coarse, tm, "a photo of a cat", **kw)

    modes = ("0", "1")
    expect = {m: _expected(pipe.config, pipe, k, k, fused=m == "1") for m in modes}
    for m in modes:
        with fused_gn(m):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            record[f"sd15_gn{m}_warmup_s"] = time.perf_counter() - t0
    order = [m for _ in range(-(-timed_runs // 2)) for m in ("0", "1", "1", "0")]
    secs, shapes, peaks = {m: [] for m in modes}, {}, {}
    for m in order[: 2 * timed_runs]:
        with fused_gn(m):
            torch.cuda.reset_peak_memory_stats()
            t, sh = edit_once(f"sd15 FREEFINE_FUSED_GN={m}", run, expect[m], store, (h, w))
        secs[m].append(t)
        peaks[m] = max(peaks.get(m, 0), torch.cuda.max_memory_allocated())
        if shapes.setdefault(m, sh) != sh:
            raise AssertionError(f"sd15: launches by shape differ between edits: {sh}")
    record["sd15"] = {}
    for m in modes:
        _edit_record(record["sd15"], f"fused_gn_{m}", secs[m], shapes[m], expect[m], peaks[m],
                     record["card"])
    record["sd15"]["order"] = order[: 2 * timed_runs]
    record["sd15"]["protocol"] = ("SD-1.5 512^2, 50-step DDIM, start 35, guidance 7.5, eta 1.0, "
                                  "TCA, bf16 random weights, batch 1; FREEFINE_FUSED_GN 0 and 1 "
                                  "in turns")
    if profile:
        for m in modes:
            with fused_gn(m):
                record[f"sd15_profile_gn{m}"] = profile_edit(run, f"profile_sd15_gn{m}.txt")
    return shapes["1"]


def unused_tail_ms(pipe, run):
    """Device-stream time, per edit, of the forward of the differentiated
    energy pass (grad mode on) in total and from up block 2 to conv_out,
    which no gradient reads (the features tapped are up blocks 0 and 1),
    from CUDA events recorded by forward hooks during one edit."""
    import torch

    unet = pipe.unet
    marks = {"start": [], "tail": [], "end": []}

    def mark(name):
        def hook(*_):
            if torch.is_grad_enabled():
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks[name].append(ev)
        return hook

    handles = [unet.register_forward_pre_hook(mark("start")),
               unet.up_blocks[2].resnets[0].register_forward_pre_hook(mark("tail")),
               unet.conv_out.register_forward_hook(mark("end"))]
    try:
        run()
    finally:
        for hd in handles:
            hd.remove()
    torch.cuda.synchronize()
    if not marks["start"] or not len(marks["start"]) == len(marks["tail"]) == len(marks["end"]):
        seen = {k: len(v) for k, v in marks.items()}
        raise AssertionError(f"differentiated passes not seen: {seen}")
    total = sum(a.elapsed_time(b) for a, b in zip(marks["start"], marks["end"]))
    tail = sum(a.elapsed_time(b) for a, b in zip(marks["tail"], marks["end"]))
    return dict(passes=len(marks["start"]), forward_ms=total, unused_tail_ms=tail,
                unused_share=tail / total)


def phase_guided(record, pipe, case, store, timed_runs, profile):
    """The full-width energy-guided edit with `guided_generation`'s defaults."""
    img, mask, coarse, tm = case
    h, w = pipe.config.height, pipe.config.width
    num_step, start_step, fraction = 50, 25, 0.6
    kw = dict(energy_scale=2.0, energy_fraction=fraction, guidance_scale=7.5, eta=1.0,
              num_step=num_step, start_step=start_step, end_step=10, method_type="tca",
              seed=42)
    k = num_step - start_step
    energy_steps = int(round(k * fraction))

    def run():
        return pipe.guided_generation(img, mask, coarse, tm, "a photo of a cat", **kw)

    expect = _expected(pipe.config, pipe, k, k, energy_steps)
    shapes = timed_edits(record, "sd15_guided", run, expect, timed_runs, store, (h, w))
    record["sd15_guided"]["protocol"] = (
        "SD-1.5 512^2, guided_generation defaults: 50-step DDIM, start 25, energy on the first "
        f"{energy_steps} of {k} steps, energy scale 2.0, guidance 7.5, eta 1.0, TCA, bf16 "
        "random weights, batch 1")
    tail = unused_tail_ms(pipe, run)
    record["sd15_guided"]["differentiated_forward"] = tail
    log(f"  differentiated forward: {tail['forward_ms']:.1f} ms per edit over "
        f"{tail['passes']} passes, of which up blocks 2-3 and conv_out (read by no gradient) "
        f"{tail['unused_tail_ms']:.1f} ms ({tail['unused_share']:.3f}) [{record['card']}]")
    if profile:
        record["sd15_guided_profile"] = profile_edit(run, "profile_sd15_guided.txt")
    return shapes


def phase_bggen(record, pipe, case, store, timed_runs, profile):
    """The full-width object removal with `background_generation`'s
    defaults and the fused GroupNorm."""
    img, mask, _, _ = case
    h, w = pipe.config.height, pipe.config.width
    num_step, start_step = 50, 1
    k = num_step - start_step

    def run():
        return pipe.background_generation(img, mask, "an empty wooden table", seed=42)

    expect = _expected(pipe.config, pipe, k, k, fused=True)
    with fused_gn("1"):
        shapes = timed_edits(record, "sd15_bggen", run, expect, timed_runs, store, (h, w))
        if profile:
            record["sd15_bggen_profile"] = profile_edit(run, "profile_sd15_bggen.txt")
    record["sd15_bggen"]["protocol"] = (
        "SD-1.5 512^2, background_generation defaults: 50-step DDIM, start 1, guidance 3.5, "
        "eta 1.0, TCA, FREEFINE_FUSED_GN=1, bf16 random weights, batch 1")
    return shapes


def phase_compose(record, pipe, case, store, timed_runs, profile):
    """The full-width composition of 2 source images (start 25, TCA) with
    the fused GroupNorm."""
    img, mask, coarse, tm = case
    h, w = pipe.config.height, pipe.config.width
    src2, _ = _case(h, w, 5)
    mask2 = np.zeros((h, w), np.uint8)
    mask2[h // 2 : 7 * h // 8, w // 2 : 7 * w // 8] = 255
    tgt2 = np.zeros((h, w), np.uint8)
    tgt2[h // 2 : 7 * h // 8, w // 8 : w // 2] = 255
    num_step, start_step = 50, 25
    k = num_step - start_step

    def run():
        return pipe.cross_image_composition(
            [img, src2], [mask, mask2], [tm, tgt2], coarse, ["a cat", "a dog"],
            num_step=num_step, start_step=start_step, seed=42)

    lo, hi = pipe._layer_range
    expect = _expected(pipe.config, pipe, k, k, mode="compose", encodes=3, fused=True)
    with fused_gn("1"):
        shapes = timed_edits(record, "sd15_compose", run, expect, timed_runs, store, (h, w))
        if profile:
            record["sd15_compose_profile"] = profile_edit(run, "profile_sd15_compose.txt")
    masked = sum(n for key, n in shapes.items() if key[0] == "flash_sdpa" and key[-1])
    if masked != k * (hi - lo):
        raise AssertionError(f"compose: {masked} masked flash_sdpa launches, expected "
                             f"{k * (hi - lo)} (2 sources x {hi - lo} TCA layers batched)")
    record["sd15_compose"].update(masked_flash_launches=masked, protocol=(
        "SD-1.5 512^2, cross_image_composition of 2 sources: 50-step DDIM, start 25, guidance "
        "7.5, eta 1.0, TCA, FREEFINE_FUSED_GN=1, bf16 random weights"))
    log(f"  compose: {masked} masked per-source flash_sdpa launches per edit")
    return shapes


def phase_batched(record, pipe, store, timed_runs, profile):
    """Phase 9: the batched lanes at full width, `generation`'s protocol
    over `batch_cases`: the shared-source lane (path S, BATCH_SHARED cases)
    with the fused GroupNorm off and on in turns (one warm-up of each, then
    0, 1, 1, 0), and the per-case lane (path B, BATCH_CASES cases, fused
    GroupNorm; one warm-up, `timed_runs` calls).  Case i is seeded 42 + i.
    Case 0 of the per-case lane is then held against `generation` of the
    same case and seed (reported: max and mean |diff| of the uint8 images).
    Returns the launches by call shape of S (fused GroupNorm) and B."""
    import torch

    from freefine_tpu_torch.pipeline import BatchedFreeFine

    cfg = pipe.config
    h, w = cfg.height, cfg.width
    num_step, start_step = 50, 35
    k = num_step - start_step
    kw = dict(guidance_scale=7.5, eta=1.0, num_step=num_step, start_step=start_step,
              end_step=10, method_type="tca")
    batched = BatchedFreeFine(pipe)
    cases = list(batch_cases(BATCH_SHARED))
    seeds = [42 + i for i in range(BATCH_SHARED)]

    def shared():
        return batched.generation_shared_source(cases, seed=seeds, **kw)

    def per_case():
        return batched.generation(cases[:BATCH_CASES], seed=seeds[:BATCH_CASES], **kw)

    rec = record["sd15_batched"] = {"card": record["card"]}
    # S: per step one batch-1 capture pass beside the edit pass, and the
    # source's inversion beside the cases': 3k passes outside the edit pass
    modes = ("0", "1")
    expect = {m: _expected(cfg, pipe, 3 * k, k, fused=m == "1") for m in modes}
    for m in modes:
        with fused_gn(m):
            t0 = time.perf_counter()
            shared()
            torch.cuda.synchronize()
            rec[f"shared_gn{m}_warmup_s"] = time.perf_counter() - t0
    order = [m for _ in range(-(-timed_runs // 2)) for m in ("0", "1", "1", "0")]
    secs, shapes, peaks = {m: [] for m in modes}, {}, {}
    for m in order[: 2 * timed_runs]:
        with fused_gn(m):
            torch.cuda.reset_peak_memory_stats()
            t, sh = edit_once(f"shared lane FREEFINE_FUSED_GN={m}", shared, expect[m], store,
                              (h, w), BATCH_SHARED)
        secs[m].append(t)
        peaks[m] = max(peaks.get(m, 0), torch.cuda.max_memory_allocated())
        if shapes.setdefault(m, sh) != sh:
            raise AssertionError(f"shared lane: launches by shape differ between calls: {sh}")
    for m in modes:
        _edit_record(rec, f"shared_gn{m}", secs[m], shapes[m], expect[m], peaks[m],
                     record["card"], BATCH_SHARED)
    rec["shared_order"] = order[: 2 * timed_runs]
    # B: launches per call independent of the number of cases
    expect_b = _expected(cfg, pipe, k, k, fused=True)
    with fused_gn("1"):
        shapes_b = timed_edits(rec, "per_case_gn1", per_case, expect_b, timed_runs, store,
                               (h, w), BATCH_CASES)
        batch_img, batch_lat = store["out"][0], store["lat"][0].clone()
        single = _single_edit(pipe, cases[0], seeds[0], kw)
        rec["case0_vs_single"] = _gaps(store["lat"][0], batch_lat, single, batch_img)
        if profile:
            rec["shared_gn1_profile"] = profile_edit(shared, "profile_sd15_shared_gn1.txt")
            rec["per_case_gn1_profile"] = profile_edit(per_case, "profile_sd15_per_case_gn1.txt")
    rec["protocol"] = (
        f"SD-1.5 512^2, generation's protocol (50-step DDIM, start 35, guidance 7.5, eta 1.0, "
        f"TCA, use_auto_draw, reduce_inp_artifacts), bf16 random weights; shared-source lane at "
        f"batch {BATCH_SHARED} with FREEFINE_FUSED_GN 0 and 1 in turns, per-case lane at batch "
        f"{BATCH_CASES} with FREEFINE_FUSED_GN=1; case i: batch_cases(i), seed 42 + i")
    gap = rec["case0_vs_single"]
    log(f"  per-case lane case 0 vs generation of the same case and seed: uint8 max |diff| "
        f"{gap['image_max_level_diff']}, mean {gap['image_mean_level_diff']:.4f}; final latents "
        f"max |diff| {gap['latent_max_abs_diff']:.4g}, mean {gap['latent_mean_abs_diff']:.4g} "
        f"(max |latent| {gap['latent_max_abs']:.4g})")
    rec["c5_one_case_bf16"] = c5_one_case(pipe, cases[0], seeds[0], kw, store)
    rec["c5_eight_cases_f32"] = c5_f32(pipe, cases[:BATCH_CASES], seeds[:BATCH_CASES], kw)
    return shapes["1"], shapes_b


def _gaps(lat_a, lat_b, img_a, img_b) -> dict:
    """max and mean |diff| of two final latents and of two uint8 images."""
    lat = (lat_a.float() - lat_b.float()).abs()
    img = np.abs(img_a.astype(np.int32) - img_b.astype(np.int32))
    return dict(latent_max_abs_diff=float(lat.max()), latent_mean_abs_diff=float(lat.mean()),
                latent_max_abs=float(lat_b.abs().max()), image_max_level_diff=int(img.max()),
                image_mean_level_diff=float(img.mean()))


def _single_edit(pipe, case, seed, kw):
    h, w = pipe.config.height, pipe.config.width
    return pipe.generation(case["ori_img"], case["ori_mask"], case["coarse_input"],
                           case["target_mask"], case["guidance_text"], use_auto_draw=True,
                           cons_area=np.zeros((h, w), np.uint8), reduce_inp_artifacts=True,
                           seed=seed, **kw)


def c5_one_case(pipe, case, seed, kw, store):
    """C5, first check: `BatchedFreeFine.generation` of one case against
    `generation` of the same case and seed, SD-1.5 bf16, the fused
    GroupNorm (path B's route).  Each single-edit loop is its batched loop
    with one case and the single edit encodes its text as a batch of one
    does, so the final latents and the image must be bit for bit."""
    import torch

    from freefine_tpu_torch.pipeline import BatchedFreeFine

    with fused_gn("1"):
        batched = BatchedFreeFine(pipe).generation([case], seed=[seed], **kw)[0]
        lat_b = store["lat"][0].clone()
        single = _single_edit(pipe, case, seed, kw)
        lat_s = store["lat"][0].clone()
    rec = dict(_gaps(lat_s, lat_b, single, batched),
               latents_bit_equal=bool(torch.equal(lat_s, lat_b)),
               image_bit_equal=bool(np.array_equal(single, batched)))
    log(f"  C5 one case, bf16: batch of one vs generation: final latents bit-equal "
        f"{rec['latents_bit_equal']}, image bit-equal {rec['image_bit_equal']} ({rec})")
    if not (rec["latents_bit_equal"] and rec["image_bit_equal"]):
        raise AssertionError(f"C5: a batch of one differs from the single edit: {rec}")
    return rec


# C5's verdict on the f32 gap between case 0 of a batch of 8 and the single
# edit (final latents, max |diff|): under the first, batch-dependent
# rounding; above the second, a fault.
C5_ROUNDING, C5_FAULT = 1e-2, 0.1


def c5_f32(pipe, cases, seeds, kw):
    """C5, second check: case 0 of `BatchedFreeFine.generation` over
    `cases` against `generation` of the same case and seed, with the
    SD-1.5 f32 config (`sd15_pipeline_config(dtype=torch.float32)`), the
    same random weights cast to f32, TF32 off, the fused GroupNorm.
    Reports max and mean |diff| of the final latents and the images and
    the verdict (rounding below C5_ROUNDING, fault above C5_FAULT, open
    between); C5 is closed as rounding, so any other verdict fails."""
    import torch

    from freefine_tpu_torch.config import sd15_pipeline_config
    from freefine_tpu_torch.pipeline import BatchedFreeFine, FreeFine

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    pipe32 = FreeFine(sd15_pipeline_config(dtype=torch.float32), device="cuda",
                      params={n: {k: v.float() for k, v in m.state_dict().items()}
                              for n, m in pipe.components().items()})
    store = {}
    _capture_latents(pipe32, store)
    try:
        with fused_gn("1"):
            t0 = time.perf_counter()
            batched = BatchedFreeFine(pipe32).generation(cases, seed=seeds, **kw)[0]
            torch.cuda.synchronize()
            batched_s = time.perf_counter() - t0
            lat_b = store["lat"][0].clone()
            single = _single_edit(pipe32, cases[0], seeds[0], kw)
            lat_s = store["lat"][0].clone()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        del pipe32
        gc.collect()  # the capture hook's closure makes a cycle with the f32 weights
        torch.cuda.empty_cache()
    rec = _gaps(lat_s, lat_b, single, batched)
    gap = rec["latent_max_abs_diff"]
    rec.update(cases=len(cases), batched_call_s=batched_s, rounding_below=C5_ROUNDING,
               fault_above=C5_FAULT,
               verdict=("rounding" if gap < C5_ROUNDING else "fault" if gap > C5_FAULT
                        else "open"))
    log(f"  C5 {len(cases)} cases, f32 (TF32 off): case 0 vs generation: final latents max "
        f"|diff| {gap:.4g}, mean {rec['latent_mean_abs_diff']:.4g} (max |latent| "
        f"{rec['latent_max_abs']:.4g}); image max {rec['image_max_level_diff']}, mean "
        f"{rec['image_mean_level_diff']:.4f} levels; verdict {rec['verdict']} (batched call "
        f"{batched_s:.1f} s)")
    if rec["verdict"] != "rounding":
        raise AssertionError(f"C5: case 0 of {len(cases)} in f32 differs from the single edit "
                             f"by more than rounding (< {C5_ROUNDING}): {rec}")
    return rec


def probe_map_counts(cfg) -> dict:
    """Maps per key of one `attention_maps` probe, worked out from the
    config: every transformer block whose queries number at most 32 * 32
    records one self and one cross map."""
    u = cfg.unet
    nb = len(u.block_out_channels)
    counts = {}

    def add(place, level, blocks):
        if (cfg.latent_height >> level) * (cfg.latent_width >> level) <= 32 * 32 and blocks:
            for kind in ("self", "cross"):
                counts[f"{place}_{kind}"] = counts.get(f"{place}_{kind}", 0) + blocks

    for i in range(nb):
        if u.down_block_has_attn[i]:
            add("down", i, u.transformer_depth[i] * u.layers_per_block)
    add("mid", nb - 1, u.transformer_depth[nb - 1])
    for i in range(nb):
        if u.up_block_has_attn[i]:
            add("up", nb - 1 - i, u.transformer_depth[nb - 1 - i] * (u.layers_per_block + 1))
    return counts


def _same_as_runs(key, out, refs) -> dict:
    """`out` against two runs `refs` of the same edit: bit for bit with the
    first, or, where the two runs themselves differ, within their gap."""
    own = int(np.abs(refs[0].astype(np.int32) - refs[1].astype(np.int32)).max())
    gap = int(np.abs(out.astype(np.int32) - refs[0].astype(np.int32)).max())
    rec = dict(max_level_diff=gap, own_gap=own, bit_equal=bool(np.array_equal(out, refs[0])))
    if own:
        log(f"  {key}: two runs of the same edit differ by {own} levels; held within that gap")
    if (own == 0 and not rec["bit_equal"]) or gap > own:
        raise AssertionError(f"{key}: differs from the reference edit: {rec}")
    return rec


def phase_rest(record, pipe, case, store):
    """Phase 9b, the rest of the main path at SD-1.5 512^2, bf16, with
    phase 4's pipe and edit (`generation`'s protocol, the fused GroupNorm
    named "1" unless said):
      * checkpoint round trip: `save_pipeline` to a temporary directory,
        `load_sd15` back onto the card (seconds and GB/s each way), every
        tensor bit-equal, and a `FreeFine(params=loaded)` edit equal to
        the phase-4 pipe's (bit for bit, or within two of its own runs'
        gap); the directory is removed also when a check fails;
      * an edit from a 768x1024 source (coarse input and masks at that
        size): `_prep_image` on the card within 1 level of the CPU's, and
        the launches of a G edit;
      * `return_intermediates`: the image equal to the edit without it, 15
        frames of 64x64x3 uint8, the launches of a G edit;
      * one `attention_maps` probe at batch 3 at step 35 under phase 4's
        edit config: eps bit for bit `unet_apply`'s, the map counts per
        key worked out from the config (`probe_map_counts`), rows summing
        to 1 within 1e-3, its ms and peak memory;
      * the GroupNorm default: with FREEFINE_FUSED_GN unset, a G edit
        launches `group_norm_silu` as under "1"; so do one warm-up and two
        timed E edits (`guided_generation`, phase 5's protocol) and one
        differentiated TCA pass (phase 8's), whose gradient must be finite
        and non-zero; every GroupNorm shape each launches is one of
        phase 2's."""
    import tempfile
    import types

    import torch

    from freefine_tpu_torch.ops import group_norm as G
    from freefine_tpu_torch.ops.geometry import re_edit_2d
    from freefine_tpu_torch.pipeline import FreeFine
    from freefine_tpu_torch.weights import load_sd15, save_pipeline

    cfg = pipe.config
    h, w = cfg.height, cfg.width
    num_step, start_step = 50, 35
    k = num_step - start_step
    kw = dict(guidance_scale=7.5, eta=1.0, num_step=num_step, start_step=start_step,
              end_step=10, method_type="tca", use_auto_draw=True,
              cons_area=np.zeros((h, w), np.uint8), reduce_inp_artifacts=True, seed=42)
    img, mask, coarse, tm = case
    prompt = "a photo of a cat"
    expect = _expected(cfg, pipe, k, k, fused=True)
    rec = record["sd15_rest"] = {"card": record["card"]}

    # checkpoint round trip
    with fused_gn("1"):
        refs = [pipe.generation(img, mask, coarse, tm, prompt, **kw) for _ in range(2)]
    tmp = tempfile.mkdtemp(prefix="freefine_ckpt_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbytes = save_pipeline(pipe, tmp)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = {n: {k_: v.to("cuda") for k_, v in sd.items()}
                  for n, sd in load_sd15(pipe, tmp).items()}
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        unequal = [f"{n}.{k_}" for n, mod in pipe.components().items()
                   for k_, v in mod.state_dict().items()
                   if not (loaded[n][k_].dtype == v.dtype and torch.equal(loaded[n][k_], v))]
        if unequal or any(set(loaded[n]) != set(m.state_dict()) for n, m in
                          pipe.components().items()):
            raise AssertionError(f"checkpoint round trip: {len(unequal)} tensors differ, e.g. "
                                 f"{unequal[:5]}")
        pipe2 = FreeFine(cfg, params=loaded, device="cuda")
        del loaded
        with fused_gn("1"):
            out2 = pipe2.generation(img, mask, coarse, tm, prompt, **kw)
        del pipe2
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["checkpoint"] = dict(bytes=nbytes, write_s=write_s, read_s=read_s,
                             write_gb_s=nbytes / write_s / 1e9, read_gb_s=nbytes / read_s / 1e9,
                             edit=_same_as_runs("loaded pipe's edit", out2, refs))
    log(f"  checkpoint: {nbytes / 1e9:.3f} GB written by save_pipeline in {write_s:.2f} s "
        f"({nbytes / write_s / 1e9:.2f} GB/s, no fsync), read by load_sd15 onto the card in "
        f"{read_s:.2f} s ({nbytes / read_s / 1e9:.2f} GB/s, from the page cache); every tensor "
        f"bit-equal; loaded pipe's edit {rec['checkpoint']['edit']} [{record['card']}]")

    # off-size input
    big_h, big_w = 768, 1024
    img_b, mask_b = _case(big_h, big_w, 3)
    coarse_b, tm_b, _ = re_edit_2d(img_b, mask_b, dx=60, dy=-30, rotation=10, scale_x=1.1,
                                   scale_y=1.1, device="cuda")
    cpu_pipe = types.SimpleNamespace(config=cfg, device=torch.device("cpu"))
    prep = max(int(np.abs(pipe._prep_image(a).astype(np.int32)
                          - FreeFine._prep_image(cpu_pipe, a).astype(np.int32)).max())
               for a in (img_b, coarse_b))
    if prep > 1:
        raise AssertionError(f"off-size _prep_image: CUDA and CPU differ by {prep} levels")
    with fused_gn("1"):
        secs, _ = edit_once("off-size G edit", lambda: pipe.generation(
            img_b, mask_b, coarse_b, tm_b, prompt, **kw), expect, store, (h, w))
    rec["off_size"] = dict(source=[big_h, big_w], prep_cuda_vs_cpu_max_level_diff=prep,
                           seconds=secs, launches=expect)
    log(f"  off-size {big_h}x{big_w} G edit: _prep_image CUDA vs CPU max {prep} levels, "
        f"{secs:.3f} s, launches {expect}")

    # return_intermediates
    launches = {}
    with fused_gn("1"):
        from freefine_tpu_torch.ops import flash_attention as FA

        FA.reset_launch_counts()
        G.reset_launch_counts()
        out, frames = pipe.generation(img, mask, coarse, tm, prompt, return_intermediates=True,
                                      **kw)
        launches = _launch_counts()[0]
    if launches != expect:
        raise AssertionError(f"return_intermediates: launches {launches} != G's {expect}")
    if frames.shape != (k, cfg.latent_height, cfg.latent_width, 3) or frames.dtype != np.uint8:
        raise AssertionError(f"return_intermediates: frames {frames.shape} {frames.dtype}")
    rec["intermediates"] = dict(frames=list(frames.shape), launches=launches,
                                image=_same_as_runs("return_intermediates image", out, refs))
    log(f"  return_intermediates: {frames.shape[0]} frames {frames.shape[1:]} uint8, image "
        f"{rec['intermediates']['image']}, launches as G's")

    # attention_maps
    lat, t, emb, ecfg, state = tca_pass_inputs(pipe, case, "edit", start_step)
    x = torch.cat([lat[:1], lat[1:], lat[:1]])
    with fused_gn("1"):
        want = pipe.unet_apply(x, t, emb, ecfg, state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        eps, maps = pipe.attention_maps(x, t, emb, ecfg, state)
        torch.cuda.synchronize()
        probe_ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
    counts = {key: len(v) for key, v in maps.items()}
    worst_row = max(float(np.abs(m.sum(-1) - 1.0).max()) for v in maps.values() for m in v)
    shapes_ok = all(m.shape[0] == 3 and m.shape[1] <= 32 * 32
                    and m.shape[2] == (m.shape[1] if key.endswith("self") else 77)
                    for key, v in maps.items() for m in v)
    rec["attention_maps"] = dict(map_counts=counts, expected=probe_map_counts(cfg),
                                 eps_bit_equal=bool(torch.equal(eps, want)),
                                 worst_row_sum_err=worst_row, ms=probe_ms, peak_memory_bytes=peak,
                                 memory_before_bytes=base)
    log(f"  attention_maps probe (batch 3, step {start_step}): {counts}, worst row-sum error "
        f"{worst_row:.2e}, eps bit-equal {rec['attention_maps']['eps_bit_equal']}, "
        f"{probe_ms:.1f} ms, peak {peak / 2**30:.2f} GiB (before {base / 2**30:.2f}) "
        f"[{record['card']}]")
    if (counts != probe_map_counts(cfg) or not rec["attention_maps"]["eps_bit_equal"]
            or worst_row > 1e-3 or not shapes_ok):
        raise AssertionError(f"attention_maps probe: {rec['attention_maps']}")

    # the GroupNorm default
    with fused_gn(None):
        mode, route = G.fused_gn_mode(), G.fused_gn_route("cuda")
        secs, _ = edit_once("G edit, FREEFINE_FUSED_GN unset", lambda: pipe.generation(
            img, mask, coarse, tm, prompt, **kw), expect, store, (h, w))
    rec["gn_default"] = dict(mode=mode, route_on_cuda=route, seconds=secs, launches=expect)
    log(f"  FREEFINE_FUSED_GN unset: mode {mode!r}, route {route!r} on the card, G edit "
        f"{secs:.3f} s, group_norm_silu launches {expect['group_norm_silu']}")
    return gn_default_e_d(record, pipe, case, store)


def _gn_shapes_checked(key, shapes):
    """Fail on a `group_norm_silu` shape that phase 2 did not hold."""
    extra = {k[1:] for k in shapes if k[0] == "group_norm_silu"} - set(path_gn_shapes())
    if extra:
        raise AssertionError(f"{key}: GroupNorm shapes not checked in phase 2: {sorted(extra)}")


def gn_default_e_d(record, pipe, case, store):
    """Phase 9b's E and D under the default route (FREEFINE_FUSED_GN
    unset): one warm-up and two timed `guided_generation` edits at phase
    5's protocol, and one differentiated TCA pass at phase 8's, each with
    its launches (`group_norm_silu` at every GroupNorm of every UNet pass
    and VAE call) and GroupNorm shapes checked.  Returns {"E": ..., "D":
    ...}: each one's `group_norm_silu` launches by call shape."""
    import torch

    from freefine_tpu_torch.ops import flash_attention as FA
    from freefine_tpu_torch.ops import group_norm as G

    cfg = pipe.config
    h, w = cfg.height, cfg.width
    img, mask, coarse, tm = case
    num_step, start_step, fraction = 50, 25, 0.6
    k = num_step - start_step
    energy_steps = int(round(k * fraction))
    kw = dict(energy_scale=2.0, energy_fraction=fraction, guidance_scale=7.5, eta=1.0,
              num_step=num_step, start_step=start_step, end_step=10, method_type="tca",
              seed=42)
    expect = _expected(cfg, pipe, k, k, energy_steps, fused=True)
    key = "sd15_guided_gn_default"
    with fused_gn(None):
        shapes_e = timed_edits(record, key, lambda: pipe.guided_generation(
            img, mask, coarse, tm, "a photo of a cat", **kw), expect, 2, store, (h, w))
    _gn_shapes_checked(key, shapes_e)
    record[key]["protocol"] = record["sd15_guided"]["protocol"] + ", FREEFINE_FUSED_GN unset"

    inputs = tca_pass_inputs(pipe, case, "edit", 35)
    wt = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, cfg.latent_height, cfg.latent_width, 4)).astype(np.float32)).cuda()
    expect = _expected_tca_grad(cfg, pipe)
    expect["group_norm_silu"] = len(norm_calls(cfg, "unet"))
    with fused_gn(None):
        tca_grad_pass(pipe, inputs, wt)  # warm-up
        FA.reset_launch_counts()
        G.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grad = tca_grad_pass(pipe, inputs, wt)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, shapes = _launch_counts()
    if launches != expect:
        raise AssertionError(f"TCA grad pass, GN default: launches {launches} != {expect}")
    _gn_shapes_checked("TCA grad pass, GN default", shapes)
    if not (torch.isfinite(grad).all() and grad.abs().max() > 0 and torch.isfinite(loss)):
        raise AssertionError("TCA grad pass, GN default: the gradient is not finite and non-zero")
    record["sd15_tca_grad_gn_default"] = dict(
        seconds_per_pass=secs, launches=expect, grad_max_abs=float(grad.abs().max()),
        protocol=record["sd15_tca_grad"]["protocol"].replace("FREEFINE_FUSED_GN off",
                                                             "FREEFINE_FUSED_GN unset"))
    log(f"  FREEFINE_FUSED_GN unset: TCA grad pass {secs:.3f} s, launches {expect} "
        f"[{record['card']}]")
    gn = {key: n for key, n in shapes_e.items() if key[0] == "group_norm_silu"}
    return {"E": gn, "D": {key: n for key, n in shapes.items() if key[0] == "group_norm_silu"}}


def phase_sdxl(record, timed_runs, profile):
    """Phase G-XL: the full-width SDXL edit.  `SDXLFreeFine` at
    `sdxl_pipeline_config()` (1024^2, bf16, full depth, random weights
    from seed 0 made on the card), `re_edit_2d` on a 1024^2 case, then
    `generation` with `generation`'s protocol (50 DDIM steps, start 35,
    guidance 7.5, eta 1.0, TCA) and FREEFINE_FUSED_GN unset (the default:
    the kernel on the card).  One warm-up and `timed_runs` timed edits,
    each with its launches checked against the counts worked out from the
    config (`_expected`); s/edit and peak memory beside the card's line;
    with `profile`, one more edit under torch.profiler.  Returns the launches of one edit by call shape (each must be a shape
    phase 2 held: `summarize` fails otherwise)."""
    import torch

    from freefine_tpu_torch.config import sdxl_pipeline_config
    from freefine_tpu_torch.sdxl import SDXLFreeFine

    cfg = sdxl_pipeline_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = SDXLFreeFine(cfg, init_random=True, seed=0, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    weights_bytes = torch.cuda.max_memory_allocated()
    store = {}
    _capture_latents(pipe, store)
    img, mask, coarse, tm = edit_case(cfg)
    h, w = cfg.height, cfg.width
    num_step, start_step = 50, 35
    k = num_step - start_step
    kw = dict(guidance_scale=7.5, eta=1.0, num_step=num_step, start_step=start_step,
              end_step=10, method_type="tca", use_auto_draw=True,
              cons_area=np.zeros((h, w), np.uint8), reduce_inp_artifacts=True, seed=42)
    expect = _expected(cfg, pipe, k, k, fused=True)
    log(f"  SDXL pipe built on the card in {setup_s:.1f} s ({weights_bytes / 2**30:.2f} GiB "
        f"peak); layer range {pipe._layer_range}; expected launches per edit {expect}")
    def run():
        return pipe.generation(img, mask, coarse, tm, "a photo of a cat", **kw)

    with fused_gn(None):
        shapes = timed_edits(record, "sdxl", run, expect, timed_runs, store, (h, w))
        if profile:
            record["sdxl_profile"] = profile_edit(run, "profile_sdxl.txt")
    _gn_shapes_checked("sdxl", shapes)
    record["sdxl"].update(
        setup_s=setup_s, setup_peak_memory_bytes=weights_bytes, layer_range=pipe._layer_range,
        parameters={name: sum(p.numel() for p in mod.parameters())
                    for name, mod in pipe.components().items()},
        protocol=("SDXL 1024^2 (sdxl_pipeline_config), 50-step DDIM, start 35, guidance 7.5, "
                  "eta 1.0, TCA, bf16 random weights, batch 1, FREEFINE_FUSED_GN unset"))
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return shapes


def phase_pixart(record, timed_runs, profile):
    """Phase PX: the full-width PixArt edit.  `FreeFine` at
    `pixart_pipeline_config()` (512^2, bf16: the PixArt-XL-2 DiT and the
    T5-XXL caption tower; random weights from seed 0 made on the card).
    The T5 encode of the edit's two prompts ("" and the guidance text) is
    timed (one warm-up, then `timed_runs` calls) and must be finite, of
    shape [2, 120, 4096] and not all zeros.  Then `re_edit_2d` on a 512^2
    case and `generation` with phase 4's protocol (50 DDIM steps, start
    35, guidance 7.5, eta 1.0, TCA) and FREEFINE_FUSED_GN unset: one
    warm-up and `timed_runs` timed edits, each with its launches checked
    against the counts worked out from the config (`_expected`: the DiT's
    28 self-attentions a pass, 10 of them TCA in the regeneration, and the
    VAE's); s/edit and peak memory beside the card's line; with `profile`,
    one more edit under torch.profiler.  Returns the launches of one edit
    by call shape (each must be a shape phase 2 held)."""
    import torch

    from freefine_tpu_torch.config import pixart_pipeline_config
    from freefine_tpu_torch.pipeline import FreeFine

    cfg = pixart_pipeline_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = FreeFine(cfg, init_random=True, seed=0, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    weights_bytes = torch.cuda.max_memory_allocated()
    prompts = ["", "a photo of a cat"]
    emb = pipe.encode_text(prompts)
    secs = []
    for _ in range(timed_runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb = pipe.encode_text(prompts)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    t5 = dict(seconds=secs, shape=list(emb.shape), finite=bool(torch.isfinite(emb).all()),
              mean_abs=float(emb.abs().mean()), std=float(emb.std()))
    log(f"  PixArt pipe built on the card in {setup_s:.1f} s ({weights_bytes / 2**30:.2f} GiB "
        f"peak); T5-XXL encode of 2 prompts {secs} s, output {t5['shape']} mean |x| "
        f"{t5['mean_abs']:.3g}, std {t5['std']:.3g} [{record['card']}]")
    if t5["shape"] != [2, cfg.text.max_length, cfg.text.d_model] or not t5["finite"] or \
            not t5["mean_abs"] > 0:
        raise AssertionError(f"PixArt T5 encode: {t5}")
    store = {}
    _capture_latents(pipe, store)
    img, mask, coarse, tm = edit_case(cfg)
    h, w = cfg.height, cfg.width
    num_step, start_step = 50, 35
    k = num_step - start_step
    kw = dict(guidance_scale=7.5, eta=1.0, num_step=num_step, start_step=start_step,
              end_step=10, method_type="tca", use_auto_draw=True,
              cons_area=np.zeros((h, w), np.uint8), reduce_inp_artifacts=True, seed=42)
    expect = _expected(cfg, pipe, k, k, fused=True)
    log(f"  layer range {pipe._layer_range}; expected launches per edit {expect}")

    def run():
        return pipe.generation(img, mask, coarse, tm, "a photo of a cat", **kw)

    with fused_gn(None):
        shapes = timed_edits(record, "pixart", run, expect, timed_runs, store, (h, w))
        if profile:
            record["pixart_profile"] = profile_edit(run, "profile_pixart.txt")
    _gn_shapes_checked("pixart", shapes)
    record["pixart"].update(
        setup_s=setup_s, setup_peak_memory_bytes=weights_bytes, layer_range=pipe._layer_range,
        t5_encode=t5,
        parameters={name: sum(p.numel() for p in mod.parameters())
                    for name, mod in pipe.components().items()},
        protocol=("PixArt-XL-2 + T5-XXL 512^2 (pixart_pipeline_config), 50-step DDIM, start 35, "
                  "guidance 7.5, eta 1.0, TCA, bf16 random weights, batch 1, "
                  "FREEFINE_FUSED_GN unset"))
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return shapes


# ---------------------------------------------------------------------------
# Phase 3D: the depth-based 3D edit (and its tiny checks of phase 3)
# ---------------------------------------------------------------------------

# the tiny perception configs of phase 3 (those of tests/test_perception.py)
TINY_DINO = dict(dim=32, depth=3, heads=2, pos_embed_size=4)
TINY_DEPTH = dict(dim=32, depth=4, heads=2, pos_embed_size=4)
TINY_SAM = dict(img_size=64, patch_size=16, patch_embed_dim=32, depth=2, num_heads=2,
                neck_dim=32, decoder_mlp_dim=64, decoder_heads=2, upscaling_dims=(16, 8),
                iou_hidden_dim=16)
RY20 = (0, 0, 0, 0, 20, 0, 1, 1, 1)
# pixels whose splat coverage may flip between two scatter-add orders
MASK_SHARE = 5e-4


def _tiny_pair(make, seed):
    """A tiny model on the CPU with the bench's random weights (biases
    moved off 0) and its copy on the card."""
    import torch

    from freefine_tpu_torch.weights import random_weights

    cpu = random_weights(make("cpu"), seed)
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for p in cpu.parameters():
            if p.ndim == 1:
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    gpu = make("cuda")
    gpu.load_state_dict(cpu.state_dict())
    return cpu.eval(), gpu.eval()


def _held(out, name, got, want, label="3D"):
    """CUDA against the CPU: max |diff| over max |ref| within TINY_TOL."""
    import torch

    got, want = torch.as_tensor(got).float().cpu(), torch.as_tensor(want).float()
    err = float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))
    out[name] = dict(max_abs_err_of_max_ref=err, tol=TINY_TOL,
                     finite=bool(torch.isfinite(got).all()))
    log(f"  tiny {label} {name} CUDA vs CPU: max |diff| {err:.3g} of max |ref| "
        f"(tol {TINY_TOL})")
    if not err <= TINY_TOL or not out[name]["finite"]:
        raise AssertionError(f"tiny {label} {name}: CUDA and CPU disagree: {out[name]}")


def _masks_held(out, name, got, want, share=MASK_SHARE, images=(), label="3D"):
    """Masks equal except at `share` of the pixels (scatter-add orders), each
    (got, want) image pair within 1 level where the masks agree."""
    differ = (np.asarray(got) > 0) != (np.asarray(want) > 0)
    levels = [int(np.abs(a.astype(int) - b.astype(int))[~differ].max()) for a, b in images]
    out[name] = dict(mask_pixels_differ=int(differ.sum()), pixels=int(differ.size),
                     image_max_level_diff=max(levels, default=0))
    log(f"  tiny {label} {name} CUDA vs CPU: {int(differ.sum())} of {differ.size} mask "
        f"pixels differ, images {out[name]['image_max_level_diff']} levels where they agree")
    if differ.mean() > share or out[name]["image_max_level_diff"] > 1:
        raise AssertionError(f"tiny {label} {name}: CUDA and CPU disagree: {out[name]}")


def phase_tiny_3d(record):
    """Phase 3's 3D checks, CUDA against the CPU with the same float32
    weights (TF32 off): the tiny DINOv2 (at its native position grid and
    off it, the last 3 blocks' outputs), Depth-Anything and EfficientSAM
    (masks and IoUs of a box and of points; `segment_with_box`) forwards;
    the tiny depth through `make_depth_fn`; `re_edit_3d_depth` and
    `author_case` on it.  Into record["tiny_3d"]."""
    import torch

    from freefine_tpu_torch.data.author3d import make_depth_fn
    from freefine_tpu_torch.models.depth_anything import DepthAnything, DepthAnythingConfig
    from freefine_tpu_torch.models.dinov2 import DINOv2, DINOv2Config
    from freefine_tpu_torch.models.efficient_sam import (
        EfficientSAM,
        EfficientSAMConfig,
        segment_with_box,
    )
    from freefine_tpu_torch.ops.geodiff_warp import author_case
    from freefine_tpu_torch.ops.point_splat import re_edit_3d_depth

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = record["tiny_3d"] = {}
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        cpu, gpu = _tiny_pair(lambda d: DINOv2(DINOv2Config(**TINY_DINO), device=d), 1)
        for hw in ((56, 56), (42, 28)):
            x = torch.randn(2, 3, *hw, generator=gen)
            for i, (a, b) in enumerate(zip(gpu(x.cuda(), num_intermediate=3),
                                           cpu(x, num_intermediate=3))):
                _held(out, f"dinov2_{hw[0]}x{hw[1]}_block{i}_patch", a[0], b[0])
                _held(out, f"dinov2_{hw[0]}x{hw[1]}_block{i}_cls", a[1], b[1])
        da_cfg = DepthAnythingConfig(backbone=DINOv2Config(**TINY_DEPTH), features=16,
                                     out_channels=(8, 16, 16, 32))
        da_cpu, da_gpu = _tiny_pair(lambda d: DepthAnything(da_cfg, device=d), 2)
        for m in (da_cpu, da_gpu):   # a ReLU'd output that is not all zeros
            m.head.conv3.bias.add_(1.0)
        x = torch.randn(1, 3, 56, 56, generator=gen)
        _held(out, "depth_anything", da_gpu(x.cuda()), da_cpu(x))
        sam_cpu, sam_gpu = _tiny_pair(
            lambda d: EfficientSAM(EfficientSAMConfig(**TINY_SAM), device=d), 3)
        imgs = torch.rand(1, 3, 48, 80, generator=gen)
        for name, pts, lbl in (("box", [[[[10.0, 12.0], [40.0, 44.0]]]], [[[2.0, 3.0]]]),
                               ("points", [[[[20.0, 30.0], [50.0, 41.0]]]], [[[1.0, 1.0]]])):
            pts, lbl = torch.tensor(pts), torch.tensor(lbl)
            (mg, ig), (mc, ic) = sam_gpu(imgs.cuda(), pts.cuda(), lbl.cuda()), \
                sam_cpu(imgs, pts, lbl)
            _held(out, f"efficient_sam_{name}_masks", mg, mc)
            _held(out, f"efficient_sam_{name}_iou", ig, ic)
    img, mask = _case(64, 64, 5)
    _masks_held(out, "segment_with_box", segment_with_box(sam_gpu, img, (12, 10, 40, 50)),
                segment_with_box(sam_cpu, img, (12, 10, 40, 50)), share=1e-3)
    depth = make_depth_fn(model=da_cpu, size=56)(img)
    _held(out, "make_depth_fn", make_depth_fn(model=da_gpu, size=56)(img), depth)
    f = 0.92 * 64
    coarse = {dev: re_edit_3d_depth(img, mask, depth + 1.0, RY20, focal_length_x=f,
                                    focal_length_y=f, device=dev) for dev in ("cpu", "cuda")}
    _masks_held(out, "re_edit_3d_depth", coarse["cuda"][1], coarse["cpu"][1],
                images=[(coarse["cuda"][0], coarse["cpu"][0])])
    bg = np.full_like(img, 90)
    warp = {dev: author_case(img, mask, depth, bg, (4, -2, 0, 10, 20, 0, 1, 1, 1),
                             focal_length=0.9 * 64, device=dev) for dev in ("cpu", "cuda")}
    _masks_held(out, "author_case", warp["cuda"][1], warp["cpu"][1],
                images=[(warp["cuda"][0], warp["cpu"][0])])
    for i, name in ((2, "author_case_mesh"), (3, "author_case_md")):
        _masks_held(out, name, warp["cuda"][i], warp["cpu"][i])
    _held(out, "author_case_coords", warp["cuda"][4], warp["cpu"][4])


def _bbox(mask) -> tuple:
    ys, xs = np.nonzero(mask)
    return int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())


def counted(key, fn, expect):
    """fn() with the launch counters set to 0 just before and read just
    after; they must equal `expect` (or `expect()`, called after fn).  ->
    (output, seconds, launches by shape)."""
    import torch

    from freefine_tpu_torch.ops import flash_attention as FA
    from freefine_tpu_torch.ops import group_norm as G

    FA.reset_launch_counts()
    G.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, shapes = _launch_counts()
    if callable(expect):  # worked out from what the call reports
        expect = expect()
    if launches != expect:
        raise AssertionError(f"{key}: launch counts {launches} != expected {expect}")
    return out, secs, shapes


def _timed_counted(key, fn, expect, timed_runs):
    """One warm-up, then `timed_runs` `counted` calls: -> (last output,
    milliseconds, launches by shape of one call)."""
    fn()
    ms, first = [], None
    for _ in range(timed_runs):
        res, secs, shapes = counted(key, fn, expect)
        ms.append(secs * 1e3)
        if first is not None and shapes != first:
            raise AssertionError(f"{key}: launches by shape differ between calls: {shapes}")
        first = shapes
    return res, ms, first


def phase_3d(record, pipe, store, timed_runs, profile):
    """Phase 3D: the depth-based 3D edit at full width on phase 4's SD-1.5
    512^2 pipe (bf16).  Phase 4's source image and object; EfficientSAM
    ViT-S (`efficient_sam_vits`, f32, 1024^2 inside; random weights made on
    the card) segments the object's box (`segment_with_box`); Depth-Anything
    ViT-L (`depth_anything_vitl`, DINOv2 ViT-L/14 and DPT features 256, f32,
    random weights made on the card) gives the depth through
    `make_depth_fn` (518^2 inside, the disparity resized to 512^2, then
    max - disparity), checked finite; the coarse edit gets that depth + 1,
    as examples/edit_3d_depth.py forms it from the disparity, so it is well
    formed whatever the weights: `re_edit_3d_depth` with ry = 20 degrees,
    `compute_correspondence`, and the GeoBench-3D authoring warp
    (`author_case`, focal 550, supersample 4, over the fast-marching
    background `inpaint_fmm` gives); each timed after a warm-up, each
    perception call's launches checked against its config (one
    `flash_sdpa` per ViT block).  Then `generation` at GeoBench-3D's
    protocol (parallel/harness.py: 50 DDIM steps, start 15, guidance 7.5,
    eta 1.0, TCA to the end, end_scale 0, the target mask as draw mask and
    cons_area, no auto draw, reduce_inp_artifacts) with FREEFINE_FUSED_GN
    unset: one warm-up and `timed_runs` timed edits, launches checked
    against `_expected` (35 inversion and 35 regeneration passes).  Returns
    the launches by shape of one 3D edit, perception included (path 3D)."""
    from collections import Counter

    import torch

    from freefine_tpu_torch import masks as mask_ops
    from freefine_tpu_torch.data.author3d import make_depth_fn
    from freefine_tpu_torch.models.depth_anything import depth_anything_vitl
    from freefine_tpu_torch.models.efficient_sam import (
        EfficientSAM,
        efficient_sam_vits,
        segment_with_box,
    )
    from freefine_tpu_torch.ops.geodiff_warp import author_case
    from freefine_tpu_torch.ops.point_splat import (
        compute_correspondence,
        inpaint_fmm,
        re_edit_3d_depth,
    )
    from freefine_tpu_torch.weights import random_weights

    cfg = pipe.config
    h, w = cfg.height, cfg.width
    img, mask, _, _ = edit_case(cfg)
    none = {k: 0 for k in _launch_counts()[0]}
    card = record["card"]
    info = {}

    sam_cfg = efficient_sam_vits()
    torch.cuda.reset_peak_memory_stats()
    sam = random_weights(EfficientSAM(sam_cfg, device=torch.device("cuda")), 0).eval()
    box = _bbox(mask)
    sam_mask, sam_ms, sam_shapes = _timed_counted(
        "EfficientSAM", lambda: segment_with_box(sam, img, box),
        {**none, "flash_sdpa": sam_cfg.depth}, timed_runs)
    info["efficient_sam"] = dict(
        ms=sam_ms, box=box, mask_pixels=int((sam_mask > 0).sum()),
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        launches=[[*k, n] for k, n in sorted(sam_shapes.items())])
    log(f"  EfficientSAM ViT-S segment_with_box {sam_ms} ms, mask "
        f"{info['efficient_sam']['mask_pixels']} px of {h * w} [{card}]")
    del sam

    da_cfg = depth_anything_vitl()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    predict = make_depth_fn("depth_anything", encoder="vitl", seed=0)
    depth, da_ms, da_shapes = _timed_counted(
        "Depth-Anything", lambda: predict(img), {**none, "flash_sdpa": da_cfg.backbone.depth},
        timed_runs)
    info["depth_anything"] = dict(
        ms=da_ms, peak_memory_bytes=torch.cuda.max_memory_allocated(),
        finite=bool(np.isfinite(depth).all()), shape=list(depth.shape),
        min=float(depth.min()), max=float(depth.max()), mean=float(depth.mean()),
        disparity_constant=bool(depth.max() == depth.min()),
        launches=[[*k, n] for k, n in sorted(da_shapes.items())])
    log(f"  Depth-Anything ViT-L depth {da_ms} ms, peak "
        f"{info['depth_anything']['peak_memory_bytes'] / 2**30:.2f} GiB, depth in "
        f"[{depth.min():.4g}, "
        f"{depth.max():.4g}], raw disparity constant: "
        f"{info['depth_anything']['disparity_constant']} [{card}]")
    if depth.shape != (h, w) or not info["depth_anything"]["finite"]:
        raise AssertionError(f"Depth-Anything depth: {info['depth_anything']}")
    del predict
    torch.cuda.empty_cache()

    depth3d = depth + 1.0
    f = 0.92 * w

    def coarse():
        return re_edit_3d_depth(img, mask, depth3d, RY20, focal_length_x=f, focal_length_y=f)

    def background():
        hole = mask_ops.binarize(mask_ops.dilate(
            torch.as_tensor((mask > 0).astype(np.float32), device="cuda"), 15))
        filled = inpaint_fmm(torch.as_tensor(img, dtype=torch.float32, device="cuda"), hole)
        return torch.round(filled).clamp(0, 255).to(torch.uint8).cpu().numpy()

    host = {}
    for name, fn in (("re_edit_3d_depth", coarse),
                     ("compute_correspondence", lambda: compute_correspondence(
                         depth3d, mask, RY20, f, f)),
                     ("inpaint_fmm_background", background)):
        host[name], ms, _ = _timed_counted(name, fn, none, timed_runs)
        info[name] = dict(ms=ms)
    bg = host["inpaint_fmm_background"]
    warp, ms, _ = _timed_counted("author_case", lambda: author_case(
        img, mask, depth, bg, RY20, focal_length=550.0, supersample=4), none, timed_runs)
    info["author_case"] = dict(ms=ms)
    coarse_img, tm, _ = host["re_edit_3d_depth"]
    corr = host["compute_correspondence"]
    info["re_edit_3d_depth"].update(target_pixels=int((tm > 0).sum()))
    info["compute_correspondence"].update(
        finite_pixels=int(np.isfinite(corr[..., 0]).sum()), object_pixels=int((mask > 0).sum()))
    info["author_case"].update(full_pixels=int((warp[1] > 0).sum()),
                               mesh_pixels=int((warp[2] > 0).sum()),
                               md_pixels=int((warp[3] > 0).sum()))
    for name in ("re_edit_3d_depth", "compute_correspondence", "inpaint_fmm_background",
                 "author_case"):
        log(f"  {name} {info[name]['ms']} ms "
            f"{ {k: v for k, v in info[name].items() if k != 'ms'} } [{card}]")
    if not 0 < info["re_edit_3d_depth"]["target_pixels"] < h * w or \
            info["compute_correspondence"]["finite_pixels"] != \
            info["compute_correspondence"]["object_pixels"] or \
            not info["author_case"]["full_pixels"] > 0:
        raise AssertionError(f"3D coarse edit: {info}")

    num_step, start_step = 50, 15
    k = num_step - start_step
    kw = dict(guidance_scale=7.5, eta=1.0, num_step=num_step, start_step=start_step,
              end_step=num_step, end_scale=0.0, method_type="tca", draw_mask=tm,
              use_auto_draw=False, cons_area=tm, reduce_inp_artifacts=True, seed=42)
    expect = _expected(cfg, pipe, k, k, fused=True)
    log(f"  expected launches per 3D edit (the generation) {expect}")

    def run():
        return pipe.generation(img, mask, coarse_img, tm, "a photo of a cat", **kw)

    with fused_gn(None):
        shapes = timed_edits(record, "edit3d", run, expect, timed_runs, store, (h, w))
        if profile:
            record["edit3d_profile"] = profile_edit(run, "profile_edit3d.txt")
    _gn_shapes_checked("edit3d", shapes)
    record["edit3d"].update(
        info, protocol=("GeoBench-3D regeneration (parallel/harness.py) on SD-1.5 512^2: "
                        "50-step DDIM, start 15, guidance 7.5, eta 1.0, TCA to the end, "
                        "end_scale 0, draw mask = cons_area = the target mask, no auto draw, "
                        "reduce_inp_artifacts, bf16 random weights, FREEFINE_FUSED_GN unset; "
                        "EfficientSAM ViT-S and Depth-Anything ViT-L f32 random weights"))
    return Counter(shapes) + Counter(sam_shapes) + Counter(da_shapes)


# ---------------------------------------------------------------------------
# Phase SV3D: the SV3D coarse 3D edit (and its tiny checks of phase 3)
# ---------------------------------------------------------------------------

# the tiny configs of phase 3 (those of tests/test_torch_sv3d.py)
TINY_VIDEO = dict(model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
                  attention_levels=(True, False), num_head_channels=8, context_dim=16,
                  adm_in_channels=24, num_frames=3, norm_num_groups=4)
TINY_VIT = dict(image_size=224, patch_size=32, hidden_size=32, intermediate_size=64,
                num_layers=2, num_heads=2, projection_dim=16, activation="gelu")
TINY_U2NET = dict(stages=((4, 4, 8), (3, 4, 8), (3, 4, 8), (3, 4, 8), (0, 4, 8), (0, 4, 8)),
                  dstages=((0, 4, 8), (3, 4, 8), (3, 4, 8), (3, 4, 8), (4, 4, 8)))
# masks from a thresholded saliency: pixels within rounding of the threshold may flip
SALIENCY_MASK_SHARE = 5e-3
# the target of phase SV3D's coarse edit (JAX's default elevation)
SV3D_AZIMUTH, SV3D_ELEVATION = 30.0, 10.0
SV3D_STEPS = 50           # the published Euler steps (sv3d_p.yaml)
SV3D_ORBIT_BUDGET_S = 360.0  # the most phase SV3D's orbit may take before its steps are cut


def _sv3d_noise(gen, t, side):
    """The sampler's two draws (conditioning augmentation, x0), made on the
    CPU from `gen`, so that both sides replay the same."""
    import torch

    return tuple(torch.randn(t, side, side, 4, generator=gen) for _ in range(2))


def phase_tiny_sv3d(record):
    """Phase 3's SV3D checks, CUDA against the CPU with the same float32
    weights and draws (TF32 off; FREEFINE_FUSED_GN unset: the kernels on
    the card, the two-pass math on the CPU): the tiny video UNet forward,
    a 3-step tiny orbit (`SV3D.sample_latents`), the tiny ViT (pooled and
    penultimate), u2netp's saliency at an even and an odd size and
    `get_mask_from_saliency`, then the tiny `re_edit_3d_sv3d` (a tiny UNet
    attending at its 36^2 level, the tiny SD-1.5 config's VAE, tiny ViT and
    U^2-Net; a 576^2 frame) and `generation` at GeoBench-3D's protocol on
    its output.  Into record["tiny_sv3d"]."""
    import torch

    from freefine_tpu_torch.config import tiny_pipeline_config
    from freefine_tpu_torch.models import u2net as U
    from freefine_tpu_torch.models.clip_image import CLIPImageEncoder, CLIPVisionConfig
    from freefine_tpu_torch.models.sv3d import SV3D, re_edit_3d_sv3d
    from freefine_tpu_torch.models.vae import AutoencoderKL
    from freefine_tpu_torch.models.video_unet import VideoUNet, VideoUNetConfig
    from freefine_tpu_torch.pipeline import FreeFine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = record["tiny_sv3d"] = {}
    gen = torch.Generator().manual_seed(17)
    vcfg = VideoUNetConfig(**TINY_VIDEO, dtype=torch.float32)
    t = vcfg.num_frames
    with fused_gn(None), torch.no_grad():
        unet = _tiny_pair(lambda d: VideoUNet(vcfg, device=d), 4)
        for i, m in enumerate(unet[0].modules()):   # mix factors off 0 on both sides
            if hasattr(m, "mix_factor"):
                m.mix_factor.fill_(0.7 - 0.3 * (i % 5))
        unet[1].load_state_dict(unet[0].state_dict())
        ins = (torch.randn(t, 8, 8, 8, generator=gen), torch.rand(t, generator=gen),
               torch.randn(t, 1, 16, generator=gen), torch.randn(t, 24, generator=gen))
        _held(out, "video_unet", unet[1](*(x.cuda() for x in ins)), unet[0](*ins), "SV3D")
        cond, tok = torch.randn(1, 8, 8, 4, generator=gen), torch.randn(1, 1, 16, generator=gen)
        noise = _sv3d_noise(gen, t, 8)
        az, el = [0.0, 120.0, 240.0], [10.0] * t
        lat = {d: SV3D(unet=m, num_frames=t, num_steps=3).sample_latents(
            cond.to(d), tok.to(d), az, el, noise=tuple(n.to(d) for n in noise))
            for d, m in zip(("cpu", "cuda"), unet)}
        _held(out, "sample_latents_3_steps", lat["cuda"], lat["cpu"], "SV3D")
        vit = _tiny_pair(lambda d: CLIPImageEncoder(CLIPVisionConfig(**TINY_VIT), device=d), 5)
        x = torch.randn(2, 224, 224, 3, generator=gen)
        _held(out, "clip_image", vit[1](x.cuda()), vit[0](x), "SV3D")
        _held(out, "clip_image_penultimate", vit[1](x.cuda(), penultimate=True),
              vit[0](x, penultimate=True), "SV3D")
        u2p = _tiny_pair(lambda d: U.U2Net(U.u2netp_config(), device=d), 6)
        for hw in ((64, 64), (45, 37)):
            x = torch.rand(1, *hw, 3, generator=gen)
            _held(out, f"u2netp_{hw[0]}x{hw[1]}", u2p[1](x.cuda()), u2p[0](x), "SV3D")
        frame, _ = _case(70, 50, 9)
        _masks_held(out, "get_mask_from_saliency",
                    U.get_mask_from_saliency(u2p[1], frame, size=64),
                    U.get_mask_from_saliency(u2p[0], frame, size=64), share=SALIENCY_MASK_SHARE,
                    label="SV3D")
        pcfg = tiny_pipeline_config()
        # the coarse edit's UNet attends at its 36^2 level (the CPU side's twin at 72^2
        # would hold S^2 logits of 5184 tokens)
        ecfg = VideoUNetConfig(**{**TINY_VIDEO, "attention_levels": (False, True)},
                               dtype=torch.float32)
        eunet = _tiny_pair(lambda d: VideoUNet(ecfg, device=d), 12)
        vae = _tiny_pair(lambda d: AutoencoderKL(pcfg.vae, device=d), 7)
        u2 = _tiny_pair(lambda d: U.U2Net(U.U2NetConfig(**TINY_U2NET), device=d), 8)
    img, mask = _case(pcfg.height, pcfg.width, 10)
    side = SV3D_SIZE // 8
    noise = _sv3d_noise(gen, t, side)
    coarse = {}
    with fused_gn(None):
        for i, d in enumerate(("cpu", "cuda")):
            coarse[d] = re_edit_3d_sv3d(
                SV3D(unet=eunet[i], num_frames=t, num_steps=3), vae[i], vit[i], u2[i], img, mask,
                SV3D_AZIMUTH, SV3D_ELEVATION, noise=tuple(n.to(d) for n in noise))
    _masks_held(out, "re_edit_3d_sv3d", coarse["cuda"][1], coarse["cpu"][1],
                share=SALIENCY_MASK_SHARE, images=[(coarse["cuda"][0], coarse["cpu"][0])],
                label="SV3D")
    tm = coarse["cpu"][1]
    out["re_edit_3d_sv3d"]["target_share"] = float((tm > 0).mean())
    cpu = FreeFine(pcfg, init_random=True, seed=0, device="cpu")
    gpu = FreeFine(pcfg, params={n: m.state_dict() for n, m in cpu.components().items()},
                   device="cuda")
    stores = {name: {} for name in ("cpu", "cuda")}
    for name, pipe in (("cpu", cpu), ("cuda", gpu)):
        _capture_latents(pipe, stores[name])
    kw = dict(num_step=8, start_step=3, end_step=8, end_scale=0.0, draw_mask=tm,
              use_auto_draw=False, cons_area=tm, reduce_inp_artifacts=True)
    steps = [np.random.default_rng(11).standard_normal(
        (2, pcfg.latent_height, pcfg.latent_width, 4)).astype(np.float32) for _ in range(5)]
    imgs = {}
    with fused_gn(None):
        for name, pipe in (("cpu", cpu), ("cuda", gpu)):
            imgs[name] = pipe.generation(img, mask, coarse["cpu"][0], tm, "a photo", **kw,
                                         noise=[torch.from_numpy(z).to(name) for z in steps])
    err = float((stores["cpu"]["lat"] - stores["cuda"]["lat"]).abs().max())
    img_err = int(np.abs(imgs["cpu"].astype(int) - imgs["cuda"].astype(int)).max())
    out["generation_after_sv3d"] = dict(latent_max_abs_err=err, latent_tol=TINY_TOL,
                                        image_max_level_diff=img_err, fused_gn="unset")
    log(f"  tiny SV3D generation after the coarse edit CUDA vs CPU: latents max |diff| "
        f"{err:.3g} (tol {TINY_TOL}), image {img_err} levels; target mask "
        f"{out['re_edit_3d_sv3d']['target_share']:.3f} of the pixels")
    if not err <= TINY_TOL or img_err > 1:
        raise AssertionError(f"tiny SV3D generation: CUDA and CPU disagree: "
                             f"{out['generation_after_sv3d']}")


def phase_sv3d(record, pipe, store, timed_runs, profile):
    """Phase SV3D: the SV3D coarse 3D edit at full width, then `generation`
    refining it on phase 4's SD-1.5 512^2 pipe (bf16), FREEFINE_FUSED_GN
    unset.  SV3D_p's video UNet (`sv3d_config`: 320 channels, mult
    (1, 2, 4, 4), 21 frames, 1024-d context, adm 1280, bf16), the ViT-H/14
    image tower (f32), the SD VAE (bf16) and u2netp (f32), random weights
    made on the card; phase 4's source image and object.
    `re_edit_3d_sv3d` at azimuth 30, elevation 10 (crop to 576^2, VAE
    encode, the ViT-H token, the 21-frame orbit, the frame decoded, matted
    by U^2-Net and pasted back), first with 2 Euler steps (a warm-up, then
    one counted run: s per step), then with the published 50 (cut only if
    50 would take more than SV3D_ORBIT_BUDGET_S; the count that ran is
    recorded), each run's launches checked against `video_unet_calls`
    (per step two passes, conditional and unconditional) plus the VAE's
    encode and decode; then `generation` at phase 3D's protocol on the
    coarse image and target mask (one warm-up and `timed_runs` timed
    edits, launches checked against `_expected`).  Returns the launches by
    shape of one SV3D edit: the coarse edit and the generation (path
    SV3D)."""
    from collections import Counter

    import torch

    from freefine_tpu_torch.config import VAEConfig
    from freefine_tpu_torch.models import u2net as U
    from freefine_tpu_torch.models.clip_image import CLIPImageEncoder, clip_vit_h14
    from freefine_tpu_torch.models.sv3d import SV3D, re_edit_3d_sv3d
    from freefine_tpu_torch.models.vae import AutoencoderKL
    from freefine_tpu_torch.models.video_unet import VideoUNet, sv3d_config
    from freefine_tpu_torch.utils.profiling import StageTimer
    from freefine_tpu_torch.weights import random_weights

    cfg = pipe.config
    h, w = cfg.height, cfg.width
    img, mask, _, _ = edit_case(cfg)
    card = record["card"]
    dev = torch.device("cuda")
    none = {k: 0 for k in _launch_counts()[0]}
    info = record["sv3d"] = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ucfg = sv3d_config()
    unet = random_weights(VideoUNet(ucfg, device=dev), 0).eval()
    clip = random_weights(CLIPImageEncoder(clip_vit_h14(), device=dev), 1).eval()
    vae = random_weights(AutoencoderKL(VAEConfig(), device=dev), 2).eval()
    matting = random_weights(U.U2Net(U.u2netp_config(), device=dev), 3).eval()
    torch.cuda.synchronize()
    info.update(setup_s=time.perf_counter() - t0, parameters={
        name: sum(p.numel() for p in m.parameters())
        for name, m in (("video_unet", unet), ("clip_vit_h14", clip), ("vae", vae),
                        ("u2netp", matting))})
    log(f"  SV3D modules on the card in {info['setup_s']:.2f} s: {info['parameters']}")

    norms, attns = video_unet_calls(ucfg, SV3D_LATENT)
    flops = video_unet_pass_flops(ucfg, SV3D_LATENT)
    pass_bound_ms = 1e3 * sum(flops.values()) / PEAK_FLOPS["bfloat16"]
    vcfg = sv3d_vae_config()
    vae_norms = len(norm_calls(vcfg, "vae_encode")) + len(norm_calls(vcfg, "vae_decode"))

    def expect(steps):
        passes = 2 * steps
        return {**none, "flash_sdpa": passes * len(attns) + 2,
                "group_norm_silu": passes * len(norms) + vae_norms}

    seen = {}

    def coarse(steps):
        timer = StageTimer()
        gen = torch.Generator(device=dev).manual_seed(0)
        res = re_edit_3d_sv3d(SV3D(unet=unet, num_steps=steps), vae, clip, matting, img, mask,
                              SV3D_AZIMUTH, SV3D_ELEVATION, generator=gen, timer=timer,
                              info=seen)
        return res, timer

    with fused_gn(None):
        coarse(2)
        (_, timer2), secs2, _ = counted("SV3D coarse edit, 2 steps", lambda: coarse(2),
                                        expect(2))
        step_s = timer2.records["orbit"][0] / 2
        steps = SV3D_STEPS if SV3D_STEPS * step_s <= SV3D_ORBIT_BUDGET_S else max(
            2, int(SV3D_ORBIT_BUDGET_S // step_s))
        log(f"  2-step coarse edit {secs2:.2f} s, {step_s:.3f} s per Euler step: running "
            f"{steps} of the published {SV3D_STEPS} steps [{card}]")
        torch.cuda.reset_peak_memory_stats()
        ((coarse_img, tm), timer), secs, coarse_shapes = counted(
            "SV3D coarse edit", lambda: coarse(steps), expect(steps))
        peak = torch.cuda.max_memory_allocated()
        if profile:  # the 2-step edit: 4 of the orbit's passes, its VAE, ViT-H and matting
            record["sv3d_coarse_profile"] = profile_edit(lambda: coarse(2),
                                                         "profile_sv3d_coarse.txt")
    stages = {k: v[0] for k, v in timer.records.items()}
    x0, y0, x1, y1 = _bbox(mask)
    outside = np.ones((h, w), bool)
    outside[y0 : y1 + 1, x0 : x1 + 1] = False
    info.update(
        steps=steps, steps_published=SV3D_STEPS, steps_cut=steps != SV3D_STEPS,
        two_step_edit_s=secs2, two_step_orbit_s=timer2.records["orbit"][0],
        s_per_step=stages["orbit"] / steps, orbit_s=stages["orbit"], coarse_edit_s=secs,
        pass_flops=flops, pass_bound_ms=pass_bound_ms,
        pass_ms=1e3 * stages["orbit"] / (2 * steps),
        stage_ms={k: 1e3 * v for k, v in stages.items()}, peak_memory_bytes=peak,
        view_mask_share=seen["view_mask_share"], paste_branch=seen["view_mask_share"] > 0,
        target_share=float((tm > 0).mean()),
        launches=expect(steps), launches_by_shape=[[*k, n] for k, n in
                                                   sorted(coarse_shapes.items())])
    log(f"  SV3D coarse edit ({steps} Euler steps, {2 * steps} video UNet passes at batch 21): "
        f"{secs:.2f} s, orbit {stages['orbit']:.2f} s, {info['s_per_step']:.4f} s per Euler "
        f"step; ViT-H token {1e3 * stages['clip']:.1f} ms, VAE encode "
        f"{1e3 * stages['vae_encode']:.1f} ms, decode {1e3 * stages['vae_decode']:.1f} ms, "
        f"U^2-Net matting {1e3 * stages['matting']:.1f} ms, crop "
        f"{1e3 * stages['crop']:.1f} ms, paste {1e3 * stages['paste']:.1f} ms; peak "
        f"{peak / 2**30:.2f} GiB; launches {expect(steps)} [{card}]")
    log(f"  one video UNet pass: {info['pass_ms']:.1f} ms against a bf16 bound of "
        f"{pass_bound_ms:.1f} ms ({info['pass_bound_ms'] / info['pass_ms']:.3f} of it): "
        f"{flops['gemm_conv'] / 1e12:.2f} TFLOP of GEMMs and convolutions, "
        f"{flops['flash_sdpa'] / 1e12:.2f} in flash_sdpa, "
        f"{flops['plain_attention'] / 1e12:.3f} in plain attention [{card}]")
    log(f"  view mask {info['view_mask_share']:.4f} of the 576^2 frame: "
        + ("the paste branch ran" if info["paste_branch"] else
           "empty, so JAX's empty-mask branch ran (background returned, empty target mask)")
        + f"; target mask {info['target_share']:.4f} of the image")
    if coarse_img.shape != (h, w, 3) or coarse_img.dtype != np.uint8 or tm.shape != (h, w) or \
            not np.array_equal(coarse_img[outside], img[outside]) or \
            (tm[outside] > 0).any() or info["paste_branch"] != bool(tm.any()):
        raise AssertionError(f"SV3D coarse edit: {info}")
    del unet, clip, vae, matting
    gc.collect()
    torch.cuda.empty_cache()

    num_step, start_step = 50, 15
    k = num_step - start_step
    kw = dict(guidance_scale=7.5, eta=1.0, num_step=num_step, start_step=start_step,
              end_step=num_step, end_scale=0.0, method_type="tca", draw_mask=tm,
              use_auto_draw=False, cons_area=tm, reduce_inp_artifacts=True, seed=42)
    gexpect = _expected(cfg, pipe, k, k, fused=True)

    def run():
        return pipe.generation(img, mask, coarse_img, tm, "a photo of a cat", **kw)

    with fused_gn(None):
        gshapes = timed_edits(record, "sv3d_refine", run, gexpect, timed_runs, store, (h, w))
        if profile:
            record["sv3d_refine_profile"] = profile_edit(run, "profile_sv3d_refine.txt")
    _gn_shapes_checked("sv3d_refine", gshapes)
    _gn_shapes_checked("sv3d_coarse", coarse_shapes)
    info.update(refine_s=record["sv3d_refine"]["seconds_per_edit"], refine_launches=gexpect,
                protocol=("SV3D_p coarse edit (re_edit_3d_sv3d, azimuth 30, elevation 10, "
                          f"{steps} EDM Euler steps, triangle CFG 1..2.5, 21 frames at 576^2; "
                          "bf16 video UNet and VAE, f32 ViT-H/14 and u2netp, random weights), "
                          "then GeoBench-3D regeneration on SD-1.5 512^2 (50-step DDIM, "
                          "start 15, TCA to the end, end_scale 0, draw mask = cons_area = the "
                          "target mask), FREEFINE_FUSED_GN unset"))
    log(f"  SV3D edit: coarse {secs:.2f} s + refining generation "
        f"{record['sv3d_refine']['seconds_per_edit']} s [{card}]")
    return Counter(coarse_shapes) + Counter(gshapes)


# ---------------------------------------------------------------------------
# Phases FLOW and MG: RAFT, DIFT and the MotionGuidance baseline (and their
# tiny checks of phase 3)
# ---------------------------------------------------------------------------

# MotionGuidance on the card: the schedule cut to 2 DDIM steps of 2
# recursive steps (4 energy gradients); GeoBench's protocol runs 50 x 10
MG_STEPS, MG_RECURSIVE = 2, 2
MG_PROTOCOL_GRADIENTS = 50 * 10
# the edit of phase MG: phase 4's object translated by (40, -20) pixels
# (a GeoBench edit_param: dx, dy, dz, rx, ry, rz, scale)
MG_EDIT_PARAM = (40, -20, 0, 0, 0, 0, 1)
# the side of phase FLOW's images
FLOW_SIDE = 512


def phase_tiny_mg(record):
    """Phase 3's flow, RAFT, DIFT and MotionGuidance checks, CUDA against
    the CPU with the same float32 weights (TF32 off): `corr_block` and its
    gradient (a scatter-add on the card, whose atomics add in another
    order every run); the full-width RAFT between two 64^2 images at iters
    2 and its gradient to the second image; on the tiny config, the
    gradient through `vae.decode`, the DIFT featurizer (ensemble 8, the
    same noise) and `MotionGuidance.edit` (steps 2, recursion 2, the same
    draws) at guidance weight 0 (its 4 energy gradients are taken and added
    at weight 0); at the protocol's weight 300 the edit on the card must
    be finite with 4 non-zero energy gradients, its latents' distance from
    the CPU's reported and not held: the L1 energy's gradient is
    discontinuous, so decodes an ulp apart can take different sides of a
    kink and the weight carries that into the latents.  Into
    record["tiny_mg"]."""
    import torch

    from freefine_tpu_torch import config as C
    from freefine_tpu_torch.baselines.motion_guidance import MotionGuidance
    from freefine_tpu_torch.models.raft import RAFT, RAFTConfig
    from freefine_tpu_torch.ops.dift import make_sd_featurizer
    from freefine_tpu_torch.ops.flow import corr_block
    from freefine_tpu_torch.pipeline import FreeFine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = record["tiny_mg"] = {}
    gen = torch.Generator().manual_seed(11)

    def held(name, got, want):
        _held(out, name, got, want, label="MG")

    def both(fn, *xs):
        """fn on the CPU tensors and on their CUDA copies: (cuda, cpu)."""
        return fn(*(x.cuda() for x in xs)), fn(*xs)

    f1, f2 = torch.randn(2, 12, 10, 16, generator=gen), torch.randn(2, 12, 10, 16, generator=gen)
    ys, xs = torch.meshgrid(torch.arange(12.0), torch.arange(10.0), indexing="ij")
    coords = torch.stack([xs, ys], -1)[None].repeat(2, 1, 1, 1) + 3 * torch.randn(
        2, 12, 10, 2, generator=gen)
    held("corr_block", *both(corr_block, f1, f2, coords))
    cot = torch.randn(2, 12, 10, 4 * 81, generator=gen)

    def corr_grads(a, b, c, w):
        b, c = b.requires_grad_(), c.requires_grad_()
        return torch.autograd.grad((corr_block(a, b, c) * w).sum(), (b, c))

    (gb, gc), (cb, cc) = both(corr_grads, f1, f2, coords, cot)
    held("corr_block_grad_fmap2", gb, cb)
    held("corr_block_grad_coords", gc, cc)

    raft_cpu, raft_gpu = _tiny_pair(lambda d: RAFT(RAFTConfig(iters=2), device=d), 5)
    img1, img2 = torch.rand(1, 64, 64, 3, generator=gen), torch.rand(1, 64, 64, 3, generator=gen)
    with torch.no_grad():
        held("raft_flow", raft_gpu(img1.cuda(), img2.cuda()), raft_cpu(img1, img2))
    fcot = torch.randn(1, 64, 64, 2, generator=gen)
    grads = {}
    for dev, model in (("cpu", raft_cpu), ("cuda", raft_gpu)):
        y = img2.to(dev).requires_grad_()
        grads[dev], = torch.autograd.grad((model(img1.to(dev), y) * fcot.to(dev)).sum(), y)
    held("raft_grad_image2", grads["cuda"], grads["cpu"])

    cfg = C.tiny_pipeline_config()
    cpu = FreeFine(cfg, init_random=True, seed=0, device="cpu")
    gpu = FreeFine(cfg, params={n: m.state_dict() for n, m in cpu.components().items()},
                   device="cuda")
    lh, lw = cfg.latent_height, cfg.latent_width
    x0 = torch.randn(1, lh, lw, 4, generator=gen)
    dcot = torch.randn(1, cfg.height, cfg.width, 3, generator=gen)
    dec = {}
    for dev, pipe in (("cpu", cpu), ("cuda", gpu)):
        x = x0.to(dev).requires_grad_()
        dec[dev], = torch.autograd.grad(pipe.vae.decode(x), x, dcot.to(dev))
    held("vae_decode_grad", dec["cuda"], dec["cpu"])
    img, mask = _case(cfg.height, cfg.width, 6)
    noise = torch.randn(DIFT_ENSEMBLE, lh, lw, 4, generator=gen)
    held("dift_features", make_sd_featurizer(gpu, noise=noise)(img, "a photo"),
         make_sd_featurizer(cpu, noise=noise)(img, "a photo"))

    draws = (torch.randn(1, lh, lw, 4, generator=gen),
             torch.randn(2, 2, 2, 1, lh, lw, 4, generator=gen))
    stores = {"cpu": {}, "cuda": {}}
    for dev, pipe in (("cpu", cpu), ("cuda", gpu)):
        _capture_latents(pipe, stores[dev])
    raft2 = {"cpu": raft_cpu.requires_grad_(False), "cuda": raft_gpu.requires_grad_(False)}
    param = (7, -3, 0, 0, 0, 0, 1)
    lats = {}
    for weight in (0.0, 300.0):
        for dev, pipe in (("cpu", cpu), ("cuda", gpu)):
            MotionGuidance(pipe, raft2[dev]).edit(img, param, mask, "a photo", steps=2,
                                                  num_recursive=2, guidance_weight=weight,
                                                  noise=draws)
            lats[dev, weight] = stores[dev]["lat"]
    held("motion_guidance_edit_weight_0", lats["cuda", 0.0], lats["cpu", 0.0])
    guided = lats["cuda", 300.0]
    moved = float((guided - lats["cuda", 0.0]).abs().max())
    apart = float((guided - lats["cpu", 300.0]).abs().max())
    out["motion_guidance_edit_weight_300"] = dict(
        finite=bool(torch.isfinite(guided).all()), moved_from_weight_0=moved,
        cuda_vs_cpu_latent_max_abs_diff=apart, held=False)
    log(f"  tiny MG edit at weight 300 on the card: finite {out['motion_guidance_edit_weight_300']['finite']}, "
        f"latents {moved:.3g} from the unguided edit's, {apart:.3g} from the CPU's (not held: "
        "the L1 energy's gradient is discontinuous)")
    if not out["motion_guidance_edit_weight_300"]["finite"] or not moved > 0:
        raise AssertionError(f"tiny MG edit at weight 300: {out['motion_guidance_edit_weight_300']}")


def phase_flow(record, pipe, timed_runs):
    """Phase FLOW: RAFT at full width (hidden 128, context 128, feature maps
    of 256 channels, 4 levels, radius 4, iters 5, f32, random weights made
    on the card) between two 512^2 images: the forward, then the forward
    and backward to the second image, each timed (one warm-up, then
    `timed_runs` synchronised calls, `_timed_counted`) with its peak memory
    and its launches (none of the kernel table's: RAFT is plain PyTorch, as
    the JAX package left it to XLA); then one DIFT featurisation of a 512^2 image on phase
    4's SD-1.5 pipe (`make_sd_featurizer`: ensemble 8, t 261, up block 1,
    FREEFINE_FUSED_GN unset), timed the same way, its launches checked
    (one UNet pass at batch 8 and the VAE encode).  Returns (RAFT, the
    launches by shape of one featurisation: path DIFT)."""
    import torch

    from freefine_tpu_torch.models.raft import RAFT
    from freefine_tpu_torch.ops.dift import make_sd_featurizer
    from freefine_tpu_torch.weights import random_weights

    card = record["card"]
    info = record["flow"] = {}
    none = {k: 0 for k in _launch_counts()[0]}
    raft = random_weights(RAFT(device="cuda"), 7).eval().requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(3)
    a, b = (torch.rand(1, FLOW_SIDE, FLOW_SIDE, 3, generator=gen, device="cuda")
            for _ in range(2))
    cot = torch.randn(1, FLOW_SIDE, FLOW_SIDE, 2, generator=gen, device="cuda")

    def fwd():
        with torch.no_grad():
            return raft(a, b)

    def fwd_bwd():
        y = b.clone().requires_grad_()
        return torch.autograd.grad((raft(a, y) * cot).sum(), y)[0]

    base = torch.cuda.memory_allocated()
    for name, fn in (("raft_forward", fwd), ("raft_forward_backward", fwd_bwd)):
        torch.cuda.reset_peak_memory_stats()
        res, ms, _ = _timed_counted(f"FLOW {name}", fn, none, timed_runs)
        peak = torch.cuda.max_memory_allocated()
        if not torch.isfinite(res).all() or \
                res.shape != (1, FLOW_SIDE, FLOW_SIDE, 2 if fn is fwd else 3):
            raise AssertionError(f"{name}: output {tuple(res.shape)}, finite "
                                 f"{bool(torch.isfinite(res).all())}")
        info[name] = dict(ms=ms, peak_memory_bytes=peak, peak_over_resident_bytes=peak - base,
                          out_abs_max=float(res.abs().max()))
        log(f"  {name} at {FLOW_SIDE}^2 (iters 5, f32): {ms} ms, peak {peak / 2**30:.2f} GiB "
            f"({(peak - base) / 2**30:.2f} over the resident) [{card}]")

    cfg = pipe.config
    img, _, _, _ = edit_case(cfg)
    featurize = make_sd_featurizer(pipe, ensemble_size=DIFT_ENSEMBLE)
    n_layers, _ = cfg.unet.attn_layer_layout
    expect = _expected(cfg, pipe, 0, 0, encodes=1, decodes=0, fused=True)
    expect["flash_sdpa"] += n_layers
    expect["group_norm_silu"] += len(norm_calls(cfg, "unet"))
    torch.cuda.reset_peak_memory_stats()
    with fused_gn(None):
        feat, ms, shapes = _timed_counted("DIFT", lambda: featurize(img, "a photo of a cat"),
                                          expect, timed_runs)
    peak = torch.cuda.max_memory_allocated()
    _gn_shapes_checked("DIFT", shapes)
    c = cfg.unet.block_out_channels[-2]
    if feat.shape != (cfg.height, cfg.width, c) or not np.isfinite(feat).all():
        raise AssertionError(f"DIFT features {feat.shape}, finite {np.isfinite(feat).all()}")
    info["dift"] = dict(ms=ms, peak_memory_bytes=peak, peak_over_resident_bytes=peak - base,
                        feature_shape=list(feat.shape), launches=expect,
                        launches_by_shape=[[*k, n] for k, n in sorted(shapes.items())],
                        protocol="make_sd_featurizer: ensemble 8, t 261, up block 1, "
                                 "FREEFINE_FUSED_GN unset; host clock around each call, "
                                 "its [512, 512, C] float32 copy to the host included")
    log(f"  DIFT featurisation of a 512^2 image (ensemble {DIFT_ENSEMBLE}, t 261): {ms} ms, "
        f"features {list(feat.shape)}, peak {peak / 2**30:.2f} GiB, launches {expect} [{card}]")
    return raft, shapes


def _expected_mg(cfg, pipe, grads: int, fused: bool) -> dict:
    """Launches of one `MotionGuidance.edit` of `grads` energy gradients,
    worked out from the config: the source's VAE encode and the final
    decode (one `flash_sdpa` each, and their GroupNorms); per gradient the
    UNet at batch 2 and the decoder under autograd: every UNet layer and the
    decoder's mid-block head through the forward with logsumexp, dQ and
    dK/dV (the gradient reaches every layer), and with the fused GroupNorm
    every norm of both forwards (the backward recomputes the two-pass
    math)."""
    n_layers, _ = cfg.unet.attn_layer_layout
    expect = _expected(cfg, pipe, 0, 0, encodes=1, decodes=1, fused=fused)
    for name in ("flash_sdpa_fwd_lse", "flash_sdpa_bwd_dq", "flash_sdpa_bwd_dkv"):
        expect[name] = grads * (n_layers + 1)
    if fused:
        expect["group_norm_silu"] += grads * (len(norm_calls(cfg, "unet"))
                                              + len(norm_calls(cfg, "vae_decode")))
    return expect


def phase_mg(record, pipe, raft, store):
    """Phase MG: `MotionGuidance.edit` on phase 4's SD-1.5 512^2 pipe (bf16
    UNet and VAE, the VAE's attention in f32) with phase FLOW's full-width
    RAFT, GeoBench's protocol
    (CFG 7.5, eta 0, guidance weight 300, clip 200, colour 100 and flow 3,
    the analytic flow of `MG_EDIT_PARAM` over phase 4's object) with the
    schedule cut to MG_STEPS DDIM steps of MG_RECURSIVE recursive steps
    (4 energy gradients).  One warm-up under each GroupNorm route, then
    edits under the default ("auto") and "0" in turns (auto, 0, 0, auto),
    each counted against `_expected_mg`; per energy gradient its device time
    and its split across the UNet, the decode and RAFT with the loss
    (`EnergyTimer`: CUDA events at the `mg::` ranges' boundaries, forward
    and backward); the first default edit's peak memory, launches by shape
    (path MG), gradients (finite, non-zero inside the object) and output;
    the full protocol's 500 gradients projected from the mean.  Returns
    the launches by shape of one default edit."""
    import torch

    from freefine_tpu_torch.baselines.motion_guidance import STAGES, EnergyTimer, MotionGuidance

    card = record["card"]
    cfg = pipe.config
    img, mask, _, _ = edit_case(cfg)
    mg = MotionGuidance(pipe, raft)
    grads_n = MG_STEPS * MG_RECURSIVE
    kw = dict(steps=MG_STEPS, num_recursive=MG_RECURSIVE, seed=42)
    info = record["mg"] = dict(
        protocol=("GeoBench MotionGuidance (CFG 7.5, eta 0, guidance 300, clip 200, colour "
                  f"100, flow 3) cut to {MG_STEPS} DDIM steps x {MG_RECURSIVE} recursive "
                  f"steps; edit_param {MG_EDIT_PARAM}; bf16 UNet and VAE, f32 RAFT (iters "
                  "5); random weights"), runs=[])
    shapes, grads = None, []
    orig_grad = torch.autograd.grad

    def spy(outputs, inputs, *a, **k):
        res = orig_grad(outputs, inputs, *a, **k)
        if res[0].shape == (1, cfg.latent_height, cfg.latent_width, 4):
            grads.append(res[0].detach().float())
        return res

    def edit(timer=None):
        return mg.edit(img, MG_EDIT_PARAM, mask, "a photo of a cat", timer=timer, **kw)

    for mode in (None, "0"):
        with fused_gn(mode):
            edit()
    for i, mode in enumerate((None, "0", "0", None)):
        expect = _expected_mg(cfg, pipe, grads_n, fused=mode is None)
        timer = EnergyTimer()
        torch.cuda.reset_peak_memory_stats()
        first = i == 0
        if first:
            torch.autograd.grad = spy
        try:
            with fused_gn(mode):
                res, secs, sh = counted(f"MG edit (GroupNorm {mode or 'auto'})",
                                        lambda: edit(timer), expect)
        finally:
            torch.autograd.grad = orig_grad
        torch.cuda.synchronize()
        split = timer.split_ms()
        run = dict(fused_gn=mode or "auto", seconds=secs,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   gradient_ms=[r["total"] for r in split],
                   split_ms={k: float(np.mean([r[k] for r in split])) for k in STAGES},
                   launches=expect)
        info["runs"].append(run)
        log(f"  MG edit, GroupNorm {run['fused_gn']}: {secs:.3f} s, energy gradients "
            f"{[round(x, 2) for x in run['gradient_ms']]} ms (mean split "
            + ", ".join(f"{k} {v:.1f}" for k, v in run["split_ms"].items())
            + f" ms), peak {run['peak_memory_bytes'] / 2**30:.2f} GiB, launches {expect} [{card}]")
        if first:
            shapes = sh
            if res.shape != (cfg.height, cfg.width, 3) or res.dtype != np.uint8 or \
                    not torch.isfinite(store["lat"]).all():
                raise AssertionError(f"MG edit output {res.shape} {res.dtype}")
            obj = torch.as_tensor(mask[4::8, 4::8] > 127, device=grads[0].device)
            inside = [float(g[0][obj].abs().max()) for g in grads]
            info.update(gradient_abs_max_inside_object=inside,
                        launches_by_shape=[[*k, n] for k, n in sorted(sh.items())])
            if len(grads) != grads_n or not all(torch.isfinite(g).all() for g in grads) or \
                    not min(inside) > 0:
                raise AssertionError(f"MG energy gradients: {len(grads)}, inside the object "
                                     f"{inside}")
    _gn_shapes_checked("MG", shapes)
    by_mode = {m: [x for r in info["runs"] if r["fused_gn"] == m for x in r["gradient_ms"]]
               for m in ("auto", "0")}
    mean_auto = float(np.mean(by_mode["auto"]))
    info.update(
        gradient_ms_mean={m: float(np.mean(v)) for m, v in by_mode.items()},
        projection=dict(label="projection, not a measurement: the mean device time of one "
                              "energy gradient (GroupNorm auto) times the protocol's 50 x 10",
                        gradients=MG_PROTOCOL_GRADIENTS,
                        seconds=MG_PROTOCOL_GRADIENTS * mean_auto / 1e3))
    log(f"  MG energy gradient: {mean_auto:.1f} ms (GroupNorm auto) against "
        f"{info['gradient_ms_mean']['0']:.1f} ms (GroupNorm 0), paired; projection, not a "
        f"measurement: {info['projection']['seconds']:.1f} s for the protocol's "
        f"{MG_PROTOCOL_GRADIENTS} gradients [{card}]")
    return shapes


# ---------------------------------------------------------------------------
# Phases RD, DE, SG and GD: the RegionDrag, DesignEdit, SelfGuidance and
# GeoDiffuser baselines (and their tiny checks of phase 3)
# ---------------------------------------------------------------------------

# the tiny baseline edits of phase 3: 4 steps each
TINY_BASELINE_STEPS = 4
# SelfGuidance's edit_param (dx, dy as fractions, rz degrees, sx, sy) and
# GeoDiffuser's (dx, dy pixels) on the card: phase 4's move, rotation and scale
SG_EDIT_PARAM = (40 / 512, -20 / 512, 0, 0, 0, 10, 1.1, 1.1, 1)
GD_EDIT_PARAM = (40, -20, 0, 0, 0, 10, 1.1, 1.1, 1)
# the GroupNorm pairing of the gradient baselines (C2): cut edits of this
# many steps (SelfGuidance 3 gradients, GeoDiffuser 4), auto / 0 in turns
PAIRED_STEPS = 4


def phase_tiny_baselines(record):
    """Phase 3's RegionDrag, DesignEdit, SelfGuidance and GeoDiffuser
    checks: each tiny edit (4 steps) on CUDA against the CPU with the same
    float32 weights and draws (TF32 off), final latents within TINY_TOL of
    max |ref|: `drag_regions` in both methods, DesignEdit's `remove`, `pan`,
    `zoom` and `move`; and one differentiated step of each gradient
    baseline: SelfGuidance's silhouette energy through the sow pass and
    GeoDiffuser's weighted geodiff losses through the [base, edit] UNet,
    each with its gradient to the edit latent.  Run and reported, not
    held: DesignEdit's removal with a refine mask (its proximal step
    thresholds deltas of about 1e-4 on the tiny config, ROADMAP C11) and
    the whole `SelfGuidance.edit` and `GeoDiffuser.edit` (their gradient
    steps carry one level of one input pixel into 1e-2 of the latents'
    max on the CPU alone, reported beside them; ROADMAP C12).  Into
    record["tiny_baselines"]."""
    import torch

    from freefine_tpu_torch import config as C
    from freefine_tpu_torch.baselines import DesignEdit, GeoDiffuser, RegionDrag, SelfGuidance
    from freefine_tpu_torch.baselines.region_drag import region_pair_to_pts
    from freefine_tpu_torch.baselines.self_guidance import silhouette_loss
    from freefine_tpu_torch.pipeline import FreeFine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = record["tiny_baselines"] = {}
    cfg = C.tiny_pipeline_config()
    cpu = FreeFine(cfg, init_random=True, seed=0, device="cpu")
    gpu = FreeFine(cfg, params={n: m.state_dict() for n, m in cpu.components().items()},
                   device="cuda")
    stores = {"cpu": {}, "cuda": {}}
    for dev, pipe in (("cpu", cpu), ("cuda", gpu)):
        _capture_latents(pipe, stores[dev])
    pipes = {"cpu": cpu, "cuda": gpu}
    h, w = cfg.height, cfg.width
    lh, lw = cfg.latent_height, cfg.latent_width
    img, mask = _case(h, w, 6)
    trg = np.roll(mask, (h // 8, w // 8), axis=(0, 1))
    trg[h // 2: h // 2 + h // 8, w // 4: w // 2] = 255   # larger: repeated source points
    gen = torch.Generator().manual_seed(19)
    steps = TINY_BASELINE_STEPS
    k = int(0.5 * steps)
    n_pts = int(2 ** np.ceil(np.log2(len(region_pair_to_pts(mask, trg, 1 / 8)[1]))))

    def run(name, fn, held=True, why="C11"):
        lats = {}
        for dev in ("cpu", "cuda"):
            fn(pipes[dev], img)
            lats[dev] = stores[dev]["lat"]
        if held:
            _held(out, name, lats["cuda"], lats["cpu"], label="baseline")
            return
        err = float((lats["cuda"] - lats["cpu"]).abs().max() / lats["cpu"].abs().max())
        nudged = img.copy()
        nudged[0, 0, 0] ^= 1
        fn(cpu, nudged)
        own = float((stores["cpu"]["lat"] - lats["cpu"]).abs().max() / lats["cpu"].abs().max())
        out[name] = dict(max_abs_err_of_max_ref=err, cpu_one_level_of_one_pixel=own, held=False,
                         finite=bool(torch.isfinite(lats["cuda"]).all()))
        log(f"  tiny baseline {name} CUDA vs CPU: {err:.3g} of max |ref|; the CPU's own edit "
            f"moves {own:.3g} when one input pixel moves one level (not held: {why})")
        if not out[name]["finite"]:
            raise AssertionError(f"tiny baseline {name}: {out[name]}")

    for method, n_blur in (("encode_then_cp", n_pts), ("cp_then_encode", 2 * n_pts)):
        fwd = [torch.randn(1, lh, lw, 4, generator=gen) for _ in range(k)]
        noise = (fwd, torch.randn(n_blur, 4, generator=gen))
        run(f"region_drag_{method}", lambda p, im: RegionDrag(p).drag_regions(
            im, mask, trg, "a photo", steps=steps, start_t=0.5, end_t=0.25, method=method,
            noise=noise))
    for name, fn in (
            ("design_remove", lambda d, im: d.remove(im, mask, "a wall", steps=steps)),
            ("design_pan", lambda d, im: d.pan(im, [("right", 0.25), ("down", 0.125)], "a room",
                                               steps=steps)),
            ("design_zoom", lambda d, im: d.zoom(im, (0.75, 0.75), "a room", steps=steps)),
            ("design_move", lambda d, im: d.move(im, mask, dx=0.25, dy=0.125, prompt="a cat",
                                                 steps=steps))):
        run(name, lambda p, im, fn=fn: fn(DesignEdit(p), im))
    refine = np.zeros_like(mask)
    refine[4: h // 3, w // 2:] = 255
    run("design_remove_refine", lambda p, im: DesignEdit(p).remove(
        im, mask, "a wall", steps=steps, refine_mask=refine), held=False)
    sg_param = (0.1, -0.05, 0, 0, 0, 15, 1.2, 0.9, 1)
    gd_param = (9, -5, 0, 0, 0, 20, 1.1, 1.1, 1)
    sg_noise = torch.randn(steps, 2, 1, lh, lw, 4, generator=gen)
    run("self_guidance_edit", lambda p, im: SelfGuidance(p).edit(
        im, "a photo of a cat", "cat", sg_param, steps=steps, noise=sg_noise), held=False,
        why="C12")
    run("geo_diffuser_edit", lambda p, im: GeoDiffuser(p).edit(im, mask, gd_param, steps=steps),
        held=False, why="C12")

    # one differentiated step of each, held
    lat = torch.randn(3, 1, lh, lw, 4, generator=gen)
    ctx_text = "a photo of a cat"
    steps_of = {}
    for dev, pipe in pipes.items():
        x0, x1, x2 = (t.to(pipe.device) for t in lat)
        ctx2 = torch.cat([pipe.encode_text([" "]), pipe.encode_text([ctx_text])])
        sg = SelfGuidance(pipe)
        select = torch.as_tensor(sg.token_select(ctx_text, "cat"), device=pipe.device)
        with torch.no_grad():
            _, ref_maps, _ = sg.apply_sow(torch.cat([x0, x0]), 601, ctx2, select)
            _, _, ori_feats = sg.apply_sow(torch.cat([x1, x1]), 601, ctx2, select)
        z = x2.clone().requires_grad_()
        _, maps, feats = sg.apply_sow(torch.cat([z, z]), 601, ctx2, select)
        sg_loss = silhouette_loss(maps, ref_maps, ori_feats, feats, 0.8, 15.0, 0.9, 1.2, -0.05,
                                  0.1, token_valid=select.sum(-1) > 0)
        sg_grad, = torch.autograd.grad(sg_loss, z)
        gd = GeoDiffuser(pipe)
        state, _ = gd.edit_state(mask, gd_param)
        state.share_gate = 1.0
        z = x2.clone().requires_grad_()
        ctx = pipe.encode_text([""])
        _, gd_loss, _ = gd._unet_losses(gd.edit_config(), torch.cat([x0, z]), 601,
                                        torch.cat([ctx, ctx]), state, 1.0)
        gd_grad, = torch.autograd.grad(gd_loss, z)
        steps_of[dev] = (sg_loss, sg_grad, gd_loss, gd_grad)
    for i, name in enumerate(("self_guidance_energy", "self_guidance_energy_grad",
                              "geo_diffuser_loss", "geo_diffuser_loss_grad")):
        if "grad" in name and not steps_of["cpu"][i].abs().max() > 0:
            raise AssertionError(f"tiny baseline {name}: zero on the CPU")
        _held(out, name, steps_of["cuda"][i].detach(), steps_of["cpu"][i].detach(),
              label="baseline")


def _expected_passes(cfg, pipe, *, no_grad=(), grad=(), encodes=1, decodes=1,
                     fused=True) -> dict:
    """Launches of a baseline edit worked out from the config: `no_grad`
    and `grad` list (UNet passes, self-attentions launched per layer) of
    the forward-only and the differentiated passes; a differentiated
    layer runs the forward with logsumexp, dQ and dK/dV once, the rest of
    its self-attentions the plain kernel; with the fused GroupNorm every
    norm of every UNet forward; one VAE attention (and its norms) per
    encode and decode."""
    n_layers, _ = cfg.unet.attn_layer_layout
    expect = _expected(cfg, pipe, 0, 0, encodes=encodes, decodes=decodes, fused=fused)
    passes = 0
    for n, per_layer in no_grad:
        expect["flash_sdpa"] += n * n_layers * per_layer
        passes += n
    for n, per_layer in grad:
        expect["flash_sdpa"] += n * n_layers * (per_layer - 1)
        for name in ("flash_sdpa_fwd_lse", "flash_sdpa_bwd_dq", "flash_sdpa_bwd_dkv"):
            expect[name] += n * n_layers
        passes += n
    if fused:
        expect["group_norm_silu"] += passes * len(norm_calls(cfg, "unet"))
    return expect


def _expected_rd(cfg, pipe, steps=50, start_t=0.5) -> dict:
    """RegionDrag's SDE edit: k = start_t * steps forward passes at batch 1
    and k reverse passes at batch 2."""
    k = int(start_t * steps)
    return _expected_passes(cfg, pipe, no_grad=[(2 * k, 1)])


def _expected_de_move(cfg, pipe, steps=50) -> dict:
    """DesignEdit's move: two encodes, the inversion of [image, image] and
    the 8-stream denoise, a pass each per step."""
    return _expected_passes(cfg, pipe, no_grad=[(2 * steps, 1)], encodes=2)


def _expected_sg(cfg, pipe, steps=50, fused=True) -> dict:
    """SelfGuidance: the inversion, the reference maps' pass, per step the
    original stream's pass, and the edit stream's, differentiated on the
    gated steps (`guidance_gates`) and forward only on the others."""
    from freefine_tpu_torch.baselines.self_guidance import guidance_gates

    n1 = int(guidance_gates(steps).sum())
    return _expected_passes(cfg, pipe, no_grad=[(steps + 1 + steps + steps - n1, 1)],
                            grad=[(n1, 1)], fused=fused)


def _expected_gd(cfg, pipe, steps=50, optimize_steps=0.95, fused=True) -> dict:
    """GeoDiffuser: the inversion (one self-attention a layer); per
    optimisation step the differentiated pass (a layer's live output
    differentiated, its warped and base outputs forward only); per step
    the denoise pass (all three forward only)."""
    n_opt = int(np.sum(np.arange(steps) < optimize_steps * steps))
    return _expected_passes(cfg, pipe, no_grad=[(steps, 1), (steps, 3)], grad=[(n_opt, 3)],
                            fused=fused)


def _baseline_record(record, key, ms, shapes, expect, peak, steps, extra=None):
    card = record["card"]
    info = record[key] = dict(seconds_per_edit=[m / 1e3 for m in ms],
                              seconds_per_step=[m / 1e3 / steps for m in ms],
                              peak_memory_bytes=peak, launches=expect,
                              launches_by_shape=[[*k, n] for k, n in sorted(shapes.items())],
                              **(extra or {}))
    _gn_shapes_checked(key, shapes)
    log(f"  {key}: s/edit {[round(x, 3) for x in info['seconds_per_edit']]}, s/step "
        f"{[round(x, 4) for x in info['seconds_per_step']]} (of {steps}), peak "
        f"{peak / 2**30:.2f} GiB, launches {expect} [{card}]")
    return info


def _edit_checked(key, store, res, hw):
    import torch

    if res.shape != (*hw, 3) or res.dtype != np.uint8 or not torch.isfinite(store["lat"]).all():
        raise AssertionError(f"{key}: output {res.shape} {res.dtype}, finite latents "
                             f"{bool(torch.isfinite(store['lat']).all())}")


def phase_rd(record, pipe, store, timed_runs):
    """Phase RD: `RegionDrag.drag_regions` on phase 4's SD-1.5 512^2 pipe at
    GeoBench's protocol (50 steps, start 0.5, end 0.2, noise scale 1, CFG
    1), the region pair phase 4's object and its coarse edit's target mask,
    FREEFINE_FUSED_GN unset; one warm-up, then `timed_runs` counted edits.
    Returns the launches by shape of one edit (path RD)."""
    import torch

    from freefine_tpu_torch.baselines import RegionDrag

    cfg = pipe.config
    img, mask, _, tm = edit_case(cfg)
    rd = RegionDrag(pipe)
    expect = _expected_rd(cfg, pipe)
    torch.cuda.reset_peak_memory_stats()
    with fused_gn(None):
        res, ms, shapes = _timed_counted(
            "RD edit", lambda: rd.drag_regions(img, mask, tm, "a photo of a cat", seed=42),
            expect, timed_runs)
    _edit_checked("RD", store, res, (cfg.height, cfg.width))
    _baseline_record(record, "rd", ms, shapes, expect, torch.cuda.max_memory_allocated(), 50,
                     dict(protocol="drag_regions: 50 steps, start 0.5, end 0.2, noise scale 1, "
                                   "method encode_then_cp; GroupNorm default"))
    return shapes


def phase_de(record, pipe, store, timed_runs):
    """Phase DE: `DesignEdit.move` on phase 4's pipe at GeoBench's protocol
    (50 steps, CFG 7.5; the layer moved by phase 4's (40, -20) pixels as
    fractions of the size), FREEFINE_FUSED_GN unset; one warm-up, then
    `timed_runs` counted edits.  Returns the launches by shape (path DE)."""
    import torch

    from freefine_tpu_torch.baselines import DesignEdit

    cfg = pipe.config
    img, mask, _, _ = edit_case(cfg)
    de = DesignEdit(pipe)
    expect = _expected_de_move(cfg, pipe)
    torch.cuda.reset_peak_memory_stats()
    with fused_gn(None):
        res, ms, shapes = _timed_counted(
            "DE edit", lambda: de.move(img, mask, dx=40 / cfg.width, dy=20 / cfg.height,
                                       prompt="a photo of a cat"), expect, timed_runs)
    _edit_checked("DE", store, res, (cfg.height, cfg.width))
    _baseline_record(record, "de", ms, shapes, expect, torch.cuda.max_memory_allocated(), 50,
                     dict(protocol="move: 50 steps, CFG 7.5, streams [original, inpaint, "
                                   "canvas, layer] x CFG (UNet batch 8); GroupNorm default"))
    return shapes


# the steps of the edit phases SG and GD count and time (the protocol's 50
# took 17.5 and 33.1 s on the H100 before this cut; PERF.md keeps them)
GRADIENT_BASELINE_STEPS = 20


def _gradient_baseline(record, key, pipe, store, edit, expected):
    """A gradient baseline's edit of GRADIENT_BASELINE_STEPS steps of the
    protocol's schedule (cut in depth from its 50) after a warm-up (a cut
    edit),
    its differentiated steps split into forward and backward by CUDA events
    (`GradStepTimer`), then the GroupNorm pairing (C2): cut edits of
    PAIRED_STEPS under the default and "0" in turns (auto, 0, 0, auto),
    each counted.  Returns the launches by shape of the full edit."""
    import torch

    from freefine_tpu_torch.utils.profiling import GradStepTimer

    cfg = pipe.config
    hw = (cfg.height, cfg.width)
    for mode in (None, "0"):
        with fused_gn(mode):
            edit(PAIRED_STEPS, None)
    timer = GradStepTimer()
    steps = GRADIENT_BASELINE_STEPS
    expect = expected(steps, True)
    torch.cuda.reset_peak_memory_stats()
    with fused_gn(None):
        res, secs, shapes = counted(f"{key} edit", lambda: edit(steps, timer), expect)
    torch.cuda.synchronize()
    _edit_checked(key, store, res, hw)
    split = timer.split_ms()
    n = len(split)
    info = _baseline_record(
        record, key.lower(), [secs * 1e3], shapes, expect, torch.cuda.max_memory_allocated(),
        steps, dict(differentiated_steps=n,
                 step_ms={k: float(np.mean([r[k] for r in split])) for k in
                          ("forward", "backward", "total")},
                 step_ms_all=[r["total"] for r in split]))
    if n != expect["flash_sdpa_bwd_dq"] // cfg.unet.attn_layer_layout[0]:
        raise AssertionError(f"{key}: {n} differentiated steps timed, launches {expect}")
    log(f"  {key} differentiated step: forward {info['step_ms']['forward']:.1f} ms, backward "
        f"{info['step_ms']['backward']:.1f} ms (mean of {n}) [{record['card']}]")
    runs = []
    for mode in (None, "0", "0", None):
        timer = GradStepTimer()
        with fused_gn(mode):
            counted(f"{key} cut edit (GroupNorm {mode or 'auto'})",
                    lambda: edit(PAIRED_STEPS, timer), expected(PAIRED_STEPS, mode is None))
        torch.cuda.synchronize()
        runs.append(dict(fused_gn=mode or "auto",
                         step_ms=[r["total"] for r in timer.split_ms()],
                         forward_ms=[r["forward"] for r in timer.split_ms()],
                         backward_ms=[r["backward"] for r in timer.split_ms()]))
    by_mode = {m: [x for r in runs if r["fused_gn"] == m for x in r["step_ms"]]
               for m in ("auto", "0")}
    info["gn_paired"] = dict(runs=runs, steps=PAIRED_STEPS,
                             step_ms_mean={m: float(np.mean(v)) for m, v in by_mode.items()})
    log(f"  {key} differentiated step, paired (auto, 0, 0, auto): "
        f"{info['gn_paired']['step_ms_mean']['auto']:.1f} ms (GroupNorm auto) against "
        f"{info['gn_paired']['step_ms_mean']['0']:.1f} ms (GroupNorm 0) [{record['card']}]")
    return shapes


def phase_sg(record, pipe, store):
    """Phase SG: `SelfGuidance.edit` on phase 4's pipe at GeoBench's
    protocol cut to GRADIENT_BASELINE_STEPS DDPM steps (CFG 7.5, a CFG-1.5
    inversion, guidance weight 15, appearance 0.8; the silhouette transform
    of phase 4's edit), its gated steps differentiated through the batch-2
    UNet (rows 3-5 and, under the default, row 9's forward).  Returns path
    SG's launches."""
    from freefine_tpu_torch.baselines import SelfGuidance

    cfg = pipe.config
    img, _, _, _ = edit_case(cfg)
    sg = SelfGuidance(pipe)

    def edit(steps, timer):
        return sg.edit(img, "a photo of a cat", "cat", SG_EDIT_PARAM, steps=steps, seed=42,
                       timer=timer)

    return _gradient_baseline(record, "SG", pipe, store, edit,
                              lambda steps, fused: _expected_sg(cfg, pipe, steps, fused))


def phase_gd(record, pipe, store):
    """Phase GD: `GeoDiffuser.edit` on phase 4's pipe at GeoBench's protocol
    cut to GRADIENT_BASELINE_STEPS steps (lr 0.03, optimisation on the first
    0.95, base pinned for 0.6, sharing for 0.97, the adaptive removal
    controller; phase 4's object moved, rotated and scaled), its optimisation steps
    differentiated through the batch-2 UNet in geodiff mode (rows 3-5 at
    batch 1, row 1 and row 9's forward).  Returns path GD's launches."""
    from freefine_tpu_torch.baselines import GeoDiffuser

    cfg = pipe.config
    img, mask, _, _ = edit_case(cfg)
    gd = GeoDiffuser(pipe)

    def edit(steps, timer):
        return gd.edit(img, mask, GD_EDIT_PARAM, steps=steps, timer=timer)

    return _gradient_baseline(record, "GD", pipe, store, edit,
                              lambda steps, fused: _expected_gd(cfg, pipe, steps, fused=fused))


# ---------------------------------------------------------------------------
# Phases DH and DD: the DiffusionHandles and DragDiffusion baselines (and
# their tiny checks of phase 3)
# ---------------------------------------------------------------------------

# DiffusionHandles' 2D edit on the card: phase 4's object moved by a fifth
# of its extent to the right and a tenth up, rotated 10 degrees and scaled
# 1.1 (GeoBench's 9 parameters, the translations relative to the extent)
DH_EDIT_PARAM = (0.2, -0.1, 0, 0, 0, 10, 1.1, 1.1, 1)
DH_PROTOCOL = dict(prompt="", steps=50, nti_iters=10, num_optsteps=3, fg_weight=1.5,
                   bg_weight=1.25, guidance_max_step=38, guidance_scale=7.5)
# DragDiffusion's GeoBench points: phase 4's move of (40, -20) pixels
DD_EDIT_PARAM = (40, -20, 0, 0, 0, 0, 1, 1, 1)
DD_PROMPT = "image of object"
DD_PROTOCOL = dict(inversion_strength=0.7, n_pix_step=80, latent_lr=0.01, r_m=1, r_p=3,
                   lam=0.1, train_lora_steps=80, lora_rank=16, lora_lr=5e-4, max_points=32,
                   seed=42)
# The edits phases DH and DD count and time, cut in depth (the protocol's
# full edits took 117.7 and 35.8 s on the H100; PERF.md keeps those
# numbers): 2 null-text gradient steps a step and 1 latent step a guided
# step (100 and 38 gradients for 500 and 114); 20 LoRA steps and at most 20
# drag iterations (for 80 and 80).  Every step is the protocol's.
DH_CUT = dict(DH_PROTOCOL, nti_iters=2, num_optsteps=1)
DD_CUT = dict(DD_PROTOCOL, n_pix_step=20, train_lora_steps=20)
# C2's pairing of one null-text gradient step and one LoRA step: this many
# steps per call, the calls under GroupNorm auto and 0 in turns
C2_PAIRED_STEPS = 3
# the tiny edits of phase 3
TINY_DH_PARAM = (0.1, -0.05, 0, 0, 0, 10, 1.1, 1.1, 1)
TINY_DH = dict(prompt="a photo", steps=2, nti_iters=2, num_optsteps=2, guidance_max_step=1)
TINY_DD = dict(n_pix_step=3, max_points=32, seed=42)


def _tiny_dd_lora(pipe, rank=2, steps=2):
    """A LoRA's initialisation and per-step draws made on the CPU, so CUDA
    and the CPU train the same one."""
    import torch

    from freefine_tpu_torch.baselines import drag_diffusion as DDM

    gen = torch.Generator().manual_seed(23)
    init = DDM.init_lora(pipe.unet, rank, gen)
    cfg = pipe.config
    draws = [(int(torch.randint(0, 1000, (), generator=gen)),
              torch.randn(1, cfg.latent_height, cfg.latent_width, 4, generator=gen))
             for _ in range(steps)]
    return init, draws


def phase_tiny_dh_dd(record):
    """Phase 3's DiffusionHandles and DragDiffusion checks, CUDA against the
    CPU with the same float32 weights (TF32 off), within TINY_TOL of max
    |ref|: one null-text gradient to the unconditional embedding, one
    guided-pass latent gradient (off the recorded latent), one LoRA step's
    gradient to every factor and its Adam update (held where the CPU's
    gradient passes 1e-3 of its max: there the first step is lr times its
    sign; the rest counted), one drag-loop gradient (the anchor off its zero
    residual); the whole tiny DiffusionHandles edit at 4 and at 5 input
    channels at the protocol's loss weights, and the whole tiny drag with
    a 2-step LoRA and no mask.  Reported beside the CPU's own one-level
    sensitivity, not held (ROADMAP C12): the drag with the union mask, on
    this case a point where Adam's sign-like steps carry a rounding
    difference.  Also reported: each first gradient's L1 residual, the
    no-grad pass against the differentiated one on each device (ROADMAP
    C13).  Into record["tiny_dh_dd"]."""
    import dataclasses

    import torch

    from freefine_tpu_torch import config as C
    from freefine_tpu_torch.baselines import DiffusionHandles, DragDiffusion
    from freefine_tpu_torch.baselines import diffusion_handles as DHM
    from freefine_tpu_torch.baselines import drag_diffusion as DDM
    from freefine_tpu_torch.baselines.eval import _drag_points_from_case
    from freefine_tpu_torch.pipeline import FreeFine
    from freefine_tpu_torch.schedulers.ddim import DDIMSchedule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = record["tiny_dh_dd"] = {}
    cfg = C.tiny_pipeline_config()
    pairs, stores = {}, {}
    for ch in (4, 5):
        c = cfg if ch == 4 else dataclasses.replace(
            cfg, unet=dataclasses.replace(cfg.unet, in_channels=5))
        cpu = FreeFine(c, init_random=True, seed=0, device="cpu")
        gpu = FreeFine(c, params={n: m.state_dict() for n, m in cpu.components().items()},
                       device="cuda")
        pairs[ch] = {"cpu": cpu, "cuda": gpu}
        for pipe in (cpu, gpu):
            stores[id(pipe)] = {}
            _capture_latents(pipe, stores[id(pipe)])
    h, w = cfg.height, cfg.width
    lh = cfg.latent_height
    img, mask = _case(h, w, 6)
    rng = np.random.default_rng(6)
    depth = rng.uniform(2.0, 6.0, (h, w)).astype(np.float32)
    tm = np.roll(mask, (-h // 16, w // 8), axis=(0, 1))
    handles, targets = _drag_points_from_case(mask, tm, (w // 8, -h // 16, 0, 0, 0, 0, 1),
                                              seed=42)
    union = ((mask > 0) | (tm > 0)).astype(np.float32)
    init, draws = _tiny_dd_lora(pairs[4]["cpu"])

    def latent_of(pipe, run, image):
        run(pipe, image)
        return stores[id(pipe)]["lat"]

    def whole(name, ch, run, held=True):
        got, want = (latent_of(pairs[ch][d], run, img) for d in ("cuda", "cpu"))
        if held:
            _held(out, name, got, want, label="baseline")
            return
        err = float((got - want).abs().max() / want.abs().max())
        nudged = img.copy()
        nudged[0, 0, 0] ^= 1
        own = float((latent_of(pairs[ch]["cpu"], run, nudged) - want).abs().max()
                    / want.abs().max())
        out[name] = dict(max_abs_err_of_max_ref=err, cpu_one_level_of_one_pixel=own, held=False,
                         finite=bool(torch.isfinite(got).all()))
        log(f"  tiny baseline {name} CUDA vs CPU: {err:.3g} of max |ref|; the CPU's own edit "
            f"moves {own:.3g} when one input pixel moves one level (not held: C12)")
        if not out[name]["finite"]:
            raise AssertionError(f"tiny baseline {name}: {out[name]}")

    def dh_run(**kw):
        return lambda p, im: DiffusionHandles(p).edit(im, depth, mask, TINY_DH_PARAM,
                                                      **TINY_DH, **kw)

    def dd_run(m):
        def run(p, im):
            lora = DDM.train_lora(p, im, DD_PROMPT, rank=2, steps=2, init=init, draws=draws)
            return DragDiffusion(p).drag(im, handles, targets, DD_PROMPT, mask=m, lora=lora,
                                         **TINY_DD)
        return run

    whole("diffusion_handles_edit_4ch", 4, dh_run())
    whole("diffusion_handles_edit_5ch", 5, dh_run())
    whole("drag_diffusion_drag_no_mask", 4, dd_run(None), held=False)
    whole("drag_diffusion_drag_union_mask", 4, dd_run(union), held=False)

    # one differentiated step of each gradient, held
    gen = torch.Generator().manual_seed(29)
    z, z_other, target = (torch.randn(1, lh, lh, 4, generator=gen) for _ in range(3))
    sched = DDIMSchedule.create(num_inference_steps=50)
    t = int(sched.timesteps[5])
    corr_np = DHM.process_correspondences(
        DHM.compute_correspondence(depth, mask > 0, TINY_DH_PARAM, device="cpu"), h, grid=lh)
    steps_of = {}
    for dev, pipe in pairs[5].items():
        put = (lambda x, d=pipe.device: x.to(d))
        ctx = pipe.encode_text(["a photo"])
        dch = DiffusionHandles(pipe).edited_disparity(depth, mask > 0, DHM.compute_correspondence(
            depth, mask > 0, TINY_DH_PARAM, device="cpu"))
        with torch.no_grad():
            eps_c = pipe.unet_apply(DHM._with_depth(put(z), dch), t, ctx)
        u = pipe.encode_text([""]).requires_grad_()
        nti = DHM.nti_loss(pipe, sched, put(z), t, u, eps_c, put(target), 7.5, dch)
        nti_grad, = torch.autograd.grad(nti, u)
        dh = DiffusionHandles(pipe)
        with torch.no_grad():
            _, feats = dh._unet(put(z_other), t, ctx, dch, True)
        corr = {k: torch.as_tensor(v, device=pipe.device) for k, v in corr_np.items()}
        zz = put(z).requires_grad_()
        fgw, bgw = np.full(3, 112.5, np.float32), np.full(3, 46.875, np.float32)
        gl = dh.guidance_loss(zz, t, ctx, dch, dh._tap(feats), corr, fgw, bgw)
        g_grad, = torch.autograd.grad(gl, zz)
        steps_of[dev] = [nti, nti_grad, gl, g_grad]
    lat0 = torch.randn(1, lh, lh, 4, generator=gen)
    noise = torch.randn(1, lh, lh, 4, generator=gen)
    b_gen = torch.Generator().manual_seed(31)
    moved = {k: {"a": ab["a"], "b": 0.05 * torch.randn(ab["b"].shape, generator=b_gen)}
             for k, ab in init.items()}
    keys = sorted(moved)
    for dev, pipe in pairs[4].items():
        put = (lambda x, d=pipe.device: x.to(d))
        ctx = pipe.encode_text([DD_PROMPT])
        lora = {k: {n: put(x).clone().requires_grad_() for n, x in ab.items()}
                for k, ab in moved.items()}
        alphas = torch.as_tensor(sched.alphas_cumprod, device=pipe.device)
        loss = DDM.lora_loss(pipe, lora, put(lat0), ctx, 437, put(noise), alphas)
        factors = [lora[k][n] for k in keys for n in ("a", "b")]
        grads = torch.autograd.grad(loss, factors)
        opt = torch.optim.Adam(factors, lr=5e-4, betas=(0.9, 0.999), eps=1e-8)
        old = [f.detach().clone() for f in factors]
        for f, g in zip(factors, grads):
            f.grad = g
        opt.step()
        flat_g = torch.cat([g.reshape(-1) for g in grads])
        update = torch.cat([(f.detach() - o).reshape(-1) for f, o in zip(factors, old)])
        # one drag-loop gradient: the motion loss and the anchor (union
        # mask), x_prev_0 taken at another latent (off the zero residual)
        dd = DragDiffusion(pipe)
        weights = DDM.merge_lora(pipe.unet, {k: {n: x.detach() for n, x in ab.items()}
                                             for k, ab in lora.items()})
        sup = (h // 2, w // 2)
        with torch.no_grad():
            eps0, _ = dd.features(weights, put(z_other), t, ctx, sup)
            x_prev_0 = DDM.ddim_prev(sched, eps0, t, put(z_other))
        hs = torch.as_tensor(np.stack([handles[:, 1] / 2, handles[:, 0] / 2], -1),
                             dtype=torch.float32, device=pipe.device)
        ts = torch.as_tensor(np.stack([targets[:, 1] / 2, targets[:, 0] / 2], -1),
                             dtype=torch.float32, device=pipe.device)
        anchor = dd.anchor_mask(DDM.resize(torch.as_tensor(union, device=pipe.device), sup,
                                           "nearest"), (lh, lh))
        code = put(z).requires_grad_()
        eps, f1 = dd.features(weights, code, t, ctx, sup)
        ml = dd.motion_loss(sched, eps, f1, code, t, hs, ts, x_prev_0, anchor, 1, 0.1)
        ml_grad, = torch.autograd.grad(ml, code)
        steps_of[dev] += [loss, flat_g, update, ml, ml_grad]
    # C13: the first gradient's L1 residuals, a latent's no-grad pass (the
    # record's taps, the drag's x_prev_0) against its differentiated pass
    for dev, pipe in pairs[4].items():
        zz = z.to(pipe.device)
        ctx = pipe.encode_text(["a photo"])
        dh, dd = DiffusionHandles(pipe), DragDiffusion(pipe)
        sup = (h // 2, w // 2)
        passes = []
        for code in (zz, zz.clone().requires_grad_()):
            with torch.set_grad_enabled(code.requires_grad):
                taps = dh._tap(dh._unet(code, t, ctx, None, True)[1])
                eps, _ = dd.features(None, code, t, ctx, sup)
                passes.append([x.detach() for x in (*taps, DDM.ddim_prev(sched, eps, t, code))])
        diff = [(a - b).abs() for a, b in zip(*passes)]
        out[f"first_gradient_residual_{dev}"] = dict(
            taps_max=max(float(d.max()) for d in diff[:3]),
            taps_nonzero=[int((d > 0).sum()) for d in diff[:3]],
            taps_numel=[int(d.numel()) for d in diff[:3]],
            x_prev_max=float(diff[3].max()), x_prev_nonzero=int((diff[3] > 0).sum()),
            x_prev_numel=int(diff[3].numel()))
        log(f"  tiny baseline first-gradient residual on {dev}: "
            f"{out[f'first_gradient_residual_{dev}']}")
    names = ("null_text_loss", "null_text_grad_u", "guided_loss", "guided_grad_latent",
             "lora_loss", "lora_grad_factors", "lora_adam_update", "drag_loss",
             "drag_grad_latent")
    cpu_g = steps_of["cpu"][names.index("lora_grad_factors")]
    sure = cpu_g.abs() > 1e-3 * cpu_g.abs().max()
    out["lora_adam_update_entries_held"] = [int(sure.sum()), int(sure.numel())]
    for i, name in enumerate(names):
        got, want = steps_of["cuda"][i].detach().cpu(), steps_of["cpu"][i].detach()
        if name == "lora_adam_update":
            got, want = got[sure], want[sure]
        if "grad" in name and not want.abs().max() > 0:
            raise AssertionError(f"tiny baseline {name}: zero on the CPU")
        _held(out, name, got, want, label="baseline")


def _expected_dh(cfg, pipe, steps=50, iters=10, optsteps=3, gms=38, fused=True) -> dict:
    """DiffusionHandles' launches, worked out from the config: no-grad UNet
    passes (the inversion; per null-text step the conditional noise and the
    closing step; the record's two per guided step; the guided pass's two
    per step), the guided gradients (every layer differentiated), and per
    null-text gradient every layer but the first, which runs ahead of the
    text and so takes no gradient."""
    n_layers, _ = cfg.unet.attn_layer_layout
    g = min(gms, steps)
    nti = steps * iters
    expect = _expected_passes(cfg, pipe, no_grad=[(5 * steps + 2 * g, 1)],
                              grad=[(g * optsteps, 1)], fused=fused)
    expect["flash_sdpa"] += nti
    for name in ("flash_sdpa_fwd_lse", "flash_sdpa_bwd_dq", "flash_sdpa_bwd_dkv"):
        expect[name] += nti * (n_layers - 1)
    if fused:
        expect["group_norm_silu"] += nti * len(norm_calls(cfg, "unet"))
    return expect


def _expected_dd(cfg, pipe, info, lora_steps=80, n_actual=35, fused=True) -> dict:
    """DragDiffusion's launches, worked out from the config and the drag
    loop's count (`info`): two encodes (LoRA, drag) and a decode; the
    LoRA steps and the drag iterations that stepped differentiated (every
    layer); the iteration that stopped, forward under autograd only; the
    no-grad passes: the inversion, the drag's reference pass and the
    MasaCtrl denoise (batch 2, one self-attention a layer)."""
    n_layers, _ = cfg.unet.attn_layer_layout
    expect = _expected_passes(cfg, pipe, no_grad=[(2 * n_actual + 1, 1)],
                              grad=[(lora_steps + info["updates"], 1)], encodes=2, fused=fused)
    stopped = info["iterations"] - info["updates"]
    expect["flash_sdpa_fwd_lse"] += stopped * n_layers
    if fused:
        expect["group_norm_silu"] += stopped * len(norm_calls(cfg, "unet"))
    return expect


def _step_ms(timer) -> dict:
    split = timer.split_ms()
    return {k: float(np.mean([r[k] for r in split])) for k in ("forward", "backward", "total")}


def _c2_pairs(key, step, expected):
    """C2: `C2_PAIRED_STEPS` differentiated steps (`step(timer)`) per call,
    the calls under GroupNorm auto and 0 in turns (auto, 0, 0, auto) after
    one warm-up call under each, each call counted against
    `expected(fused)`."""
    import torch

    from freefine_tpu_torch.utils.profiling import GradStepTimer

    def call(timer):
        for _ in range(C2_PAIRED_STEPS):
            step(timer)

    for mode in (None, "0"):
        with fused_gn(mode):
            call(GradStepTimer())
    runs = []
    for mode in (None, "0", "0", None):
        timer = GradStepTimer()
        with fused_gn(mode):
            counted(f"{key} paired steps (GroupNorm {mode or 'auto'})", lambda: call(timer),
                    expected(mode is None))
        torch.cuda.synchronize()
        runs.append(dict(fused_gn=mode or "auto", **{
            f"{k}_ms": [r[k] for r in timer.split_ms()] for k in ("total", "forward",
                                                                   "backward")}))
    mean = {m: float(np.mean([x for r in runs if r["fused_gn"] == m for x in r["total_ms"]]))
            for m in ("auto", "0")}
    log(f"  {key} step, paired (auto, 0, 0, auto): {mean['auto']:.1f} ms (GroupNorm auto) "
        f"against {mean['0']:.1f} ms (GroupNorm 0)")
    return dict(runs=runs, steps_per_call=C2_PAIRED_STEPS, step_ms_mean=mean)


def _step_launches(cfg, pipe, differentiated_layers, fused):
    """Launches of one differentiated batch-1 UNet step: the layers ahead of
    the gradient plain, the rest through rows 3-5, every norm with the fused
    GroupNorm."""
    n_layers, _ = cfg.unet.attn_layer_layout
    expect = _expected(cfg, pipe, 0, 0, encodes=0, decodes=0)
    expect["flash_sdpa"] = C2_PAIRED_STEPS * (n_layers - differentiated_layers)
    for name in ("flash_sdpa_fwd_lse", "flash_sdpa_bwd_dq", "flash_sdpa_bwd_dkv"):
        expect[name] = C2_PAIRED_STEPS * differentiated_layers
    if fused:
        expect["group_norm_silu"] = C2_PAIRED_STEPS * len(norm_calls(cfg, "unet"))
    return expect


def phase_dh(record, pipe, store):
    """Phase DH: `DiffusionHandles.edit` on phase 4's SD-1.5 512^2 pipe at
    GeoBench's protocol cut in depth (`DH_CUT`: prompt "", 50 DDIM steps,
    null-text inversion of 2 gradient steps a step for the protocol's 10, 1
    latent step a guided step for its 3 through step 38, foreground 1.5,
    background 1.25, CFG 7.5; `DH_EDIT_PARAM`), the depth
    Depth-Anything ViT-L's (random weights made on the card, as in phase
    3D) normalised by `geobench_dh_depth`, FREEFINE_FUSED_GN unset: the
    depth call counted, a cut warm-up edit, one `DH_CUT` edit counted against
    `_expected_dh`, its stages and differentiated steps timed (null-text
    and guided, forward and backward by CUDA events), its peak; then C2's
    pairing of one null-text gradient step.  Returns path DH's launches
    (the depth call's included)."""
    from collections import Counter

    import torch

    from freefine_tpu_torch.baselines import DiffusionHandles
    from freefine_tpu_torch.baselines import diffusion_handles as DHM
    from freefine_tpu_torch.baselines.eval import geobench_dh_depth
    from freefine_tpu_torch.data.author3d import make_depth_fn
    from freefine_tpu_torch.models.depth_anything import depth_anything_vitl
    from freefine_tpu_torch.schedulers.ddim import DDIMSchedule
    from freefine_tpu_torch.utils.profiling import GradStepTimer, StageTimer

    cfg = pipe.config
    card = record["card"]
    img, mask, _, _ = edit_case(cfg)
    none = {k: 0 for k in _launch_counts()[0]}
    predict = make_depth_fn("depth_anything", encoder="vitl", seed=0)
    predict(img)
    depth_expect = {**none, "flash_sdpa": depth_anything_vitl().backbone.depth}
    raw, depth_s, depth_shapes = counted("DH depth", lambda: predict(img), depth_expect)
    del predict
    torch.cuda.empty_cache()
    depth = geobench_dh_depth(raw, mask)
    dh = DiffusionHandles(pipe)
    with fused_gn(None):
        dh.edit(img, depth, mask, DH_EDIT_PARAM, steps=2, nti_iters=1, num_optsteps=1,
                guidance_max_step=1)
    timer, grads = StageTimer(), {"nti": GradStepTimer(), "guided": GradStepTimer()}
    p = DH_CUT
    expect = _expected_dh(cfg, pipe, p["steps"], p["nti_iters"], p["num_optsteps"],
                          p["guidance_max_step"])
    torch.cuda.reset_peak_memory_stats()
    with fused_gn(None):
        res, secs, shapes = counted("DH edit", lambda: dh.edit(
            img, depth, mask, DH_EDIT_PARAM, timer=timer, grad_timers=grads, **p), expect)
    _edit_checked("DH", store, res, (cfg.height, cfg.width))
    n_nti, n_guided = len(grads["nti"].steps), len(grads["guided"].steps)
    if (n_nti, n_guided) != (p["steps"] * p["nti_iters"],
                             p["guidance_max_step"] * p["num_optsteps"]):
        raise AssertionError(f"DH: {n_nti} null-text and {n_guided} guided steps timed")
    stages = {k: v["total_s"] for k, v in timer.summary().items()}
    info = _baseline_record(
        record, "dh", [secs * 1e3], shapes, expect, torch.cuda.max_memory_allocated(),
        p["steps"], dict(protocol=f"DiffusionHandles.edit {p}, edit_param {DH_EDIT_PARAM}; "
                                  "bf16 SD-1.5, random weights; GroupNorm default",
                         stages_s=stages, null_text_step_ms=_step_ms(grads["nti"]),
                         guided_step_ms=_step_ms(grads["guided"]),
                         null_text_steps=n_nti, guided_steps=n_guided,
                         depth_s=depth_s, depth_range=[float(depth.min()), float(depth.max())],
                         depth_launches=[[*k, n] for k, n in sorted(depth_shapes.items())]))
    log(f"  DH stages {({k: round(v, 2) for k, v in stages.items()})} s; null-text step "
        f"{info['null_text_step_ms']} ms, guided step {info['guided_step_ms']} ms (forward, "
        f"backward, total; means of {n_nti} and {n_guided}) [{card}]")

    sched = DDIMSchedule.create(num_inference_steps=50)
    gen = torch.Generator(device="cuda").manual_seed(37)
    lh = cfg.latent_height
    z, target = (torch.randn(1, lh, lh, 4, generator=gen, device="cuda") for _ in range(2))
    t = int(sched.timesteps[10])
    ctx = pipe.encode_text([""])
    with torch.no_grad():
        eps_c = pipe.unet_apply(z, t, ctx)
    u0 = pipe.encode_text([""])

    def nti_step(timer):
        u = u0.detach().requires_grad_()
        timer.begin()
        loss = DHM.nti_loss(pipe, sched, z, t, u, eps_c, target, 7.5)
        timer.mark("forward")
        torch.autograd.grad(loss, u)
        timer.mark("end")

    n_layers, _ = cfg.unet.attn_layer_layout
    info["gn_paired"] = _c2_pairs("DH null-text", nti_step, lambda fused: _step_launches(
        cfg, pipe, n_layers - 1, fused))
    return dict(Counter(shapes) + Counter(depth_shapes))


def phase_dd(record, pipe, store):
    """Phase DD: `DragDiffusion.drag` on phase 4's SD-1.5 512^2 pipe at
    GeoBench's protocol cut in depth (`DD_CUT`: a LoRA of rank 16 trained
    20 Adam steps for the protocol's 80 at lr 5e-4 on "image of object";
    inversion strength 0.7, at most 20 drag iterations for its 80 at
    latent lr 0.01, r_m 1, r_p 3, lam 0.1; the MasaCtrl
    denoise from step 4): at most 30 handles of phase 4's object and their
    targets by `_drag_points_from_case` (`DD_EDIT_PARAM`), the union of
    the object and its target mask, `max_points` 32, FREEFINE_FUSED_GN
    unset.  A cut warm-up, then one `DD_CUT` drag counted against
    `_expected_dd` (the drag loop's iterations read from the call), its
    stages and differentiated steps timed (LoRA and drag, forward and
    backward by CUDA events), its peak; then C2's pairing of one LoRA
    step.  Before it, a drag with every handle on its target (a 2-step
    LoRA) must stop at its first iteration with no update, its launches
    counted against `_expected_dd` too.  Returns path DD's launches."""
    import torch

    from freefine_tpu_torch.baselines import DragDiffusion
    from freefine_tpu_torch.baselines import drag_diffusion as DDM
    from freefine_tpu_torch.baselines.eval import _drag_points_from_case
    from freefine_tpu_torch.schedulers.ddim import DDIMSchedule
    from freefine_tpu_torch.utils.profiling import GradStepTimer, StageTimer

    cfg = pipe.config
    card = record["card"]
    img, mask, _, tm = edit_case(cfg)
    handles, targets = _drag_points_from_case(mask, tm, DD_EDIT_PARAM, seed=42)
    union = ((mask > 0) | (tm > 0)).astype(np.float32)
    dd = DragDiffusion(pipe)
    p = DD_CUT
    with fused_gn(None):
        dd.drag(img, handles, targets, DD_PROMPT, mask=union,
                **{**p, "train_lora_steps": 2, "n_pix_step": 2})
    n_actual = round(p["inversion_strength"] * 50)
    # the loop's stop: every handle on its target, so the first iteration
    # runs its forward only and no update is taken (2 LoRA steps)
    stop = {}
    with fused_gn(None):
        res, _, _ = counted("DD drag stopped at its first iteration", lambda: dd.drag(
            img, handles, handles, DD_PROMPT, mask=union, info=stop,
            **{**p, "train_lora_steps": 2}), lambda: _expected_dd(cfg, pipe, stop, 2, n_actual))
    if stop != {"iterations": 1, "updates": 0}:
        raise AssertionError(f"DD: the drag with every handle on its target ran {stop}")
    _edit_checked("DD stopped", store, res, (cfg.height, cfg.width))
    timer, grads, info = StageTimer(), {"lora": GradStepTimer(), "drag": GradStepTimer()}, {}
    torch.cuda.reset_peak_memory_stats()
    with fused_gn(None):
        res, secs, shapes = counted("DD drag", lambda: dd.drag(
            img, handles, targets, DD_PROMPT, mask=union, timer=timer, grad_timers=grads,
            info=info, **p), lambda: _expected_dd(cfg, pipe, info, p["train_lora_steps"],
                                                  n_actual))
    expect = _expected_dd(cfg, pipe, info, p["train_lora_steps"], n_actual)
    _edit_checked("DD", store, res, (cfg.height, cfg.width))
    stages = {k: v["total_s"] for k, v in timer.summary().items()}
    if len(grads["lora"].steps) != p["train_lora_steps"] or \
            len(grads["drag"].steps) != info["updates"]:
        raise AssertionError(f"DD: steps timed {len(grads['lora'].steps)}, "
                             f"{len(grads['drag'].steps)}; {info}")
    out = _baseline_record(
        record, "dd", [secs * 1e3], shapes, expect, torch.cuda.max_memory_allocated(), 50,
        dict(protocol=f"DragDiffusion.drag {p}, {len(handles)} points of edit_param "
                      f"{DD_EDIT_PARAM}, the union mask; bf16 SD-1.5, random weights; "
                      "GroupNorm default",
             points=len(handles), stages_s=stages, drag_iterations=info["iterations"],
             drag_updates=info["updates"], stopped_early=info["iterations"] < p["n_pix_step"]
             or info["updates"] < info["iterations"],
             lora_step_ms=_step_ms(grads["lora"]),
             drag_step_ms=_step_ms(grads["drag"]) if info["updates"] else None,
             lora_s_per_step=stages["lora"] / p["train_lora_steps"],
             drag_s_per_iteration=stages["drag"] / max(info["iterations"], 1)))
    log(f"  DD stages {({k: round(v, 2) for k, v in stages.items()})} s; {len(handles)} points, "
        f"drag iterations {info['iterations']} ({info['updates']} stepped); LoRA step "
        f"{out['lora_step_ms']} ms, drag step {out['drag_step_ms']} ms [{card}]")

    sched = DDIMSchedule.create(num_inference_steps=50)
    gen = torch.Generator(device="cuda").manual_seed(41)
    lh = cfg.latent_height
    lat, noise = (torch.randn(1, lh, lh, 4, generator=gen, device="cuda") for _ in range(2))
    ctx = pipe.encode_text([DD_PROMPT])
    init = DDM.init_lora(pipe.unet, p["lora_rank"], gen)
    lora = {k: {"a": ab["a"], "b": 0.01 * torch.randn(ab["b"].shape, generator=gen,
                                                        device="cuda")}
            for k, ab in init.items()}
    alphas = torch.as_tensor(sched.alphas_cumprod, device="cuda")

    def lora_step(timer):
        lo = {k: {n: x.detach().requires_grad_() for n, x in ab.items()} for k, ab in lora.items()}
        timer.begin()
        loss = DDM.lora_loss(pipe, lo, lat, ctx, 437, noise, alphas)
        timer.mark("forward")
        torch.autograd.grad(loss, [x for ab in lo.values() for x in ab.values()])
        timer.mark("end")

    n_layers, _ = cfg.unet.attn_layer_layout
    out["gn_paired"] = _c2_pairs("DD LoRA", lora_step, lambda fused: _step_launches(
        cfg, pipe, n_layers, fused))
    return shapes


# ---------------------------------------------------------------------------
# Phase EV: GeoBench's scoring (`metrics.main`)
# ---------------------------------------------------------------------------

EV_TASK = "111111011"  # every metric but MD (its SIFT keypoints need cv2)
EV_METRICS = ("FID", "IRS", "HPS", "BGC", "SUBC", "WRAP_E", "FID_DINO", "FID_KD")
EV_SIDE = 512
EV_SUBSET_REAL = 4
# CUDA against the CPU, one source image's two cases against EV_SUBSET_REAL
# real images, the same files and weights; relative for the FID family,
# absolute for the rest.  The CUDA run keeps PyTorch's defaults: cuDNN's
# convolutions (InceptionV3) in TF32, matmuls in float32, row 1's f32 route
# split-TF32 (float32's accuracy).  The FID family's covariances of 2 and 4
# samples are singular, and a feature's TF32 rounding moves their distance
# more than a cosine's: 2e-2.
EV_TOL = {"FID": 2e-2, "FID_DINO": 2e-2, "FID_KD": 2e-2, "IRS": 1e-3, "HPS": 1e-4,
          "BGC": 1e-4, "SUBC": 1e-4, "WRAP_E": 1e-12}
EV_RELATIVE = ("FID", "FID_DINO", "FID_KD")
# a tail batch's rows against the same images' rows in a zero-padded batch:
# ViT features (float32) and InceptionV3's (TF32 convolutions, whose cuDNN
# algorithms may differ between batch sizes), of max |ref|
EV_TAIL_TOL = {"dinov2_vitb14": 1e-4, "inception_fid": 5e-3}


def _expected_ev(n_gen: int, n_real: int, batch: int = EV_BATCH):
    """Row 1's launches by shape in one `metrics.main` call at EV_TASK,
    worked out from the encoders' configs: per generated image the BLIP
    ViT-L's layers and BERT's self- and cross-attention per layer (IRS) and
    two DINO-v1 encodes (SUBC); the DINOv2 B/14 over the generated and the
    real images in batches of `batch` (a short one padded to it on the
    card), each batch one launch a layer (FID_DINO and FID_KD share the
    features).  InceptionV3 (FID), CLIP B/32
    (BGC) and the ViT-H and OpenCLIP-H towers (HPS) launch none."""
    from collections import Counter

    from freefine_tpu_torch.metrics.consistency import dino_vitb16_config
    from freefine_tpu_torch.models.blip import BlipConfig
    from freefine_tpu_torch.models.dinov2 import dinov2_vitb14

    blip, v1, v2 = BlipConfig(), dino_vitb16_config(), dinov2_vitb14()
    d = blip.vision_width // blip.vision_heads
    img = (blip.image_size // blip.patch_size) ** 2 + 1
    txt = blip.max_text_len
    shapes = Counter()
    shapes[("flash_sdpa", 1, blip.vision_heads, img, img, d, "float32", False)] += \
        n_gen * blip.vision_layers
    shapes[("flash_sdpa", 1, blip.text_heads, txt, txt, d, "float32", True)] += \
        n_gen * blip.text_layers
    shapes[("flash_sdpa", 1, blip.text_heads, txt, img, d, "float32", False)] += \
        n_gen * blip.text_layers
    s1 = (224 // v1.patch_size) ** 2 + 1
    shapes[("flash_sdpa", 1, v1.heads, s1, s1, v1.dim // v1.heads, "float32", False)] += \
        2 * n_gen * v1.depth
    s2 = (224 // v2.patch_size) ** 2 + 1
    for n in (n_gen, n_real):
        shapes[("flash_sdpa", batch, v2.heads, s2, s2, v2.dim // v2.heads, "float32",
                False)] += -(-n // batch) * v2.depth
    totals = {k: 0 for k in _launch_counts()[0]}
    totals["flash_sdpa"] = sum(shapes.values())
    return totals, dict(shapes)


def ev_results_set(root: str) -> dict:
    """A synthetic GeoBench results set under `root`, every file written by
    `utils.image_io.write_png`: EV_IMAGES source images of EV_SIDE^2 (smooth
    random colour fields) with an object mask each, EV_CASES cases each
    (the object shifted: target mask, coarse input, a generated image), the
    results JSON, a real-image folder of EV_REAL images; and the CPU check's
    subset: the first image's cases and EV_SUBSET_REAL real images."""
    from freefine_tpu_torch.utils.image_io import write_png

    rng = np.random.default_rng(71)
    side = EV_SIDE
    yy, xx = np.mgrid[:side, :side]

    def field(h, w):
        a = np.cumsum(rng.integers(0, 9, (h, w, 3)), axis=1) + np.cumsum(
            rng.integers(0, 9, (h, 1, 3)), axis=0)
        return (a % 256).astype(np.uint8)

    data = {}
    for i in range(EV_IMAGES):
        src = field(side, side)
        cy, cx, r = side // 2 + 20 * i, side // 3 + 15 * i, side // 6
        obj = ((yy - cy) ** 2 + ((xx - cx) * 1.3) ** 2) < r ** 2
        base = {"ori_img_path": f"{root}/src_{i}.png", "ori_mask_path": f"{root}/mask_{i}.png"}
        write_png(base["ori_img_path"], src, level=1)
        write_png(base["ori_mask_path"], (obj * 255).astype(np.uint8), level=1)
        cases = {}
        for c in range(EV_CASES):
            dx = 30 + 40 * c
            tgt = np.roll(obj, dx, axis=1)
            moved = np.roll(src, dx, axis=1)
            coarse = np.where(tgt[..., None], moved, src)
            gen = np.clip(coarse.astype(int) + rng.integers(-12, 13, coarse.shape), 0, 255)
            case = dict(base, edit_param=[dx, 0, 0, 0, 0, 0, 1],
                        edit_prompt=f"move the object slightly by {dx} pixels",
                        gen_img_path=f"{root}/gen_{i}_{c}.png",
                        coarse_input_path=f"{root}/coarse_{i}_{c}.png",
                        tgt_mask_path=f"{root}/tgt_{i}_{c}.png")
            write_png(case["gen_img_path"], gen.astype(np.uint8), level=1)
            write_png(case["coarse_input_path"], coarse, level=1)
            write_png(case["tgt_mask_path"], (tgt * 255).astype(np.uint8), level=1)
            cases[str(c)] = case
        data[str(i)] = {"4v_caption": f"a photo of object {i} on a table",
                        "instances": {"0": cases}}
    for folder, n in (("real", EV_REAL), ("real_subset", EV_SUBSET_REAL)):
        os.makedirs(f"{root}/{folder}")
        for j in range(n):
            write_png(f"{root}/{folder}/real_{j:03d}.png", field(side, side), level=1)
    paths = {"full": f"{root}/results.json", "subset": f"{root}/results_subset.json"}
    with open(paths["full"], "w") as f:
        json.dump(data, f)
    with open(paths["subset"], "w") as f:
        json.dump({"0": data["0"]}, f)
    return dict(paths, real=f"{root}/real", real_subset=f"{root}/real_subset")


def _ev_inputs(name: str):
    """A timing input of each encoder on the card: a batch of EV_BATCH for
    the FID family's, one image (or prompt) for the rest."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(5)
    img = torch.randn(1, 224, 224, 3, generator=gen, device="cuda")
    if name == "inception_fid":
        return (torch.randn(EV_BATCH, 224, 224, 3, generator=gen, device="cuda"),)
    if name == "dinov2_vitb14":
        return (torch.randn(EV_BATCH, 3, 224, 224, generator=gen, device="cuda"),)
    if name == "dino_vitb16":
        return (img.permute(0, 3, 1, 2),)
    if name == "hps_text":
        return (torch.randint(2, 49408, (1, 77), generator=gen, device="cuda"),)
    if name == "image_reward":
        mask = torch.ones(1, 35, dtype=torch.long, device="cuda")
        mask[:, 12:] = 0
        return img, torch.randint(103, 30000, (1, 35), generator=gen, device="cuda"), mask
    return (img,)


def _he_scaled(layers) -> None:
    """Layers' weights rescaled from the bench's N(0, 0.02) to He's
    N(0, 2 / fan_in): InceptionV3's 94 convolutions (0.02 leaves features
    near 1e-9 and an FID near 1e-18, where float rounding is the whole
    value) and ImageReward's MLP head (0.02 leaves every score within 1e-4
    of -IR_MEAN / IR_STD, below what CUDA against the CPU can tell)."""
    import torch

    with torch.no_grad():
        for m in layers:
            m.weight.mul_((2.0 / m.weight[0].numel()) ** 0.5 / 0.02)


def ev_write_encoders(wdir: str, card: str) -> dict:
    """Each metric encoder at its published width, built on the card one at
    a time with the bench's random weights (float32, `random_weights`;
    InceptionV3's convolutions and ImageReward's head `_he_scaled`),
    written to `wdir` as `metrics.main` reads it, timed (ms per call of
    `_ev_inputs`, CUDA events) and freed before the next."""
    import torch

    from freefine_tpu_torch.metrics.main import ENCODER_FILES, build_encoder
    from freefine_tpu_torch.weights import random_weights, write_safetensors

    out = {}
    for seed, name in enumerate(ENCODER_FILES):
        t0 = time.perf_counter()
        model = random_weights(build_encoder(name, "cuda"), seed)
        if name == "inception_fid":
            _he_scaled(m for m in model.modules() if isinstance(m, torch.nn.Conv2d))
        elif name == "image_reward":
            _he_scaled(model.mlp.layers.values())
        nbytes = write_safetensors(model.state_dict(), os.path.join(wdir, f"{name}.safetensors"))
        write_s = time.perf_counter() - t0
        inputs = _ev_inputs(name)
        with torch.no_grad():
            ms = cuda_ms(lambda: model(*inputs), iters=3)
        per = "batch of 64" if name in ("inception_fid", "dinov2_vitb14") else "image"
        out[name] = dict(parameters=sum(p.numel() for p in model.parameters()), bytes=nbytes,
                         build_and_write_s=write_s, ms=ms, per=per)
        log(f"  EV encoder {name}: {out[name]['parameters'] / 1e6:.1f} M parameters, "
            f"{nbytes / 1e9:.3f} GB written in {write_s:.2f} s; {ms:.3f} ms a {per} [{card}]")
        del model, inputs
        gc.collect()
        torch.cuda.empty_cache()
    return out


def ev_tail_rows(paths: dict, wdir: str) -> dict:
    """The real folder's tail batch (EV_REAL % EV_BATCH images) through the
    FID family's models unpadded, as the CPU runs it, against the same
    images' rows of the batch zero-padded to EV_BATCH that the card's
    encoders run (`metrics.fid.pad_to`; the JAX package pads every tail):
    within EV_TAIL_TOL of max |ref|."""
    import torch

    from freefine_tpu_torch.metrics.main import build_encoder
    from freefine_tpu_torch.metrics.preprocess import fid_input_transform
    from freefine_tpu_torch.utils.image_io import read_png
    from freefine_tpu_torch.weights import read_safetensors

    real = sorted(os.listdir(paths["real"]))[-(EV_REAL % EV_BATCH):]
    tail = torch.from_numpy(np.concatenate([
        fid_input_transform(read_png(os.path.join(paths["real"], f), "RGB")) for f in real]))
    padded = torch.cat([tail, tail.new_zeros((EV_BATCH - len(tail),) + tail.shape[1:])])
    out = {}
    for name in ("dinov2_vitb14", "inception_fid"):
        model = build_encoder(name, "cuda")
        model.load_state_dict(read_safetensors(os.path.join(wdir, f"{name}.safetensors")))

        def run(x):
            x = x.cuda()
            with torch.no_grad():
                return (model(x.permute(0, 3, 1, 2))[1] if name == "dinov2_vitb14"
                        else model(x)).cpu().numpy()

        got, want = run(tail), run(padded)[:len(tail)]
        err = float(np.abs(got - want).max() / np.abs(want).max())
        out[name] = dict(rows=len(tail), max_abs_err_of_max_ref=err, tol=EV_TAIL_TOL[name],
                         bitwise_equal=bool(np.array_equal(got, want)))
        log(f"  EV tail batch {name}: {len(tail)} rows unpadded against a batch of {EV_BATCH}: "
            f"{err:.3g} of max |ref| (tol {EV_TAIL_TOL[name]}), bit for bit "
            f"{out[name]['bitwise_equal']}")
        if not err <= EV_TAIL_TOL[name]:
            raise AssertionError(f"EV tail batch {name}: {out[name]}")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _ev_checked(key: str, res: dict) -> None:
    """Every metric but MD computed, finite, in its range."""
    if sorted(res) != sorted(EV_METRICS) or any(res[m] is None or not np.isfinite(res[m])
                                                for m in EV_METRICS):
        raise AssertionError(f"{key}: metrics {res}")
    bad = [m for m, lo, hi in (("BGC", 0, 1), ("SUBC", 0, 1), ("HPS", -1, 1),
                               ("WRAP_E", 0, 1)) if not lo <= res[m] <= hi]
    if bad:
        raise AssertionError(f"{key}: {bad} out of range: {res}")


def phase_ev(record):
    """Phase EV: GeoBench's scoring through `metrics.main` at every metric
    but MD, every encoder at its published width with random weights made
    on the card (InceptionV3-FID, BLIP ImageReward's ViT-L and BERT, CLIP
    ViT-H/14 with the OpenCLIP-H text tower, CLIP B/32, DINO-v1 B/16,
    DINOv2 B/14; float32), under PyTorch's TF32 defaults (cuDNN's
    convolutions TF32, matmuls float32).  On a synthetic results set
    (`ev_results_set`): the encoders written and timed
    (`ev_write_encoders`); the FID family's tail batch against a padded one
    (`ev_tail_rows`); one `metrics.main` call counted (row 1's launches by
    shape against `_expected_ev`), each metric's seconds (its encoders'
    loading included) and the peak; then the same `main` on a subset on the
    card and with --device cpu, each metric held within EV_TOL.  Returns
    path EV's launches."""
    import tempfile

    import torch

    from freefine_tpu_torch.metrics import main as MAIN
    from freefine_tpu_torch.utils.profiling import StageTimer

    card = record["card"]
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    import scipy

    out = record["ev"] = dict(tf32=dict(cudnn_convolutions=True, matmul=False),
                              task=EV_TASK, images=EV_IMAGES, cases=EV_CASES, real=EV_REAL,
                              side=EV_SIDE, scipy=scipy.__version__)
    log(f"  EV under TF32 for cuDNN's convolutions, float32 matmuls; scipy {scipy.__version__}")
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        paths = ev_results_set(root)
        out["write_results_s"] = time.perf_counter() - t0
        wdir = os.path.join(root, "weights")
        os.makedirs(wdir)
        out["encoders"] = ev_write_encoders(wdir, card)
        out["tail_batch"] = ev_tail_rows(paths, wdir)
        common = ["--weights-dir", wdir, "--task", EV_TASK]
        n_gen = EV_IMAGES * EV_CASES
        totals, want_shapes = _expected_ev(n_gen, EV_REAL)
        timer = StageTimer()
        torch.cuda.reset_peak_memory_stats()
        res, secs, shapes = counted("EV metrics.main", lambda: MAIN.main(
            ["--path", paths["full"], "--fid_path", paths["real"], *common], timer=timer),
            totals)
        if dict(shapes) != want_shapes:
            raise AssertionError(f"EV: launches by shape {dict(shapes)} != {want_shapes}")
        _ev_checked("EV", res)
        stages = {k: v["total_s"] for k, v in timer.summary().items()}
        out.update(metrics=res, seconds=secs, stages_s=stages,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   launches=[[*k, n] for k, n in sorted(shapes.items())])
        for m in EV_METRICS:
            stage = "FID_DINO+FID_KD" if m.startswith("FID_") else m
            log(f"  EV {m}: {res[m]:.6g} ({stage} {stages[stage]:.2f} s)")
        by_shape = ", ".join(f"batch {k[1]} heads {k[2]} Sq {k[3]} Sk {k[4]}"
                             f"{' masked' if k[7] else ''}: {n}" for k, n in sorted(shapes.items()))
        log(f"  EV metrics.main: {secs:.2f} s, peak {out['peak_memory_bytes'] / 2**30:.2f} GiB; "
            f"row 1 launches {sum(shapes.values())} as the configs give ({by_shape}) [{card}]")

        sub = ["--path", paths["subset"], "--fid_path", paths["real_subset"], *common]
        got = MAIN.main(sub)
        t0 = time.perf_counter()
        want = MAIN.main(sub + ["--device", "cpu"])
        out["cpu_subset_s"] = time.perf_counter() - t0
        held = {}
        for m in EV_METRICS:
            scale = max(abs(want[m]), 1e-30) if m in EV_RELATIVE else 1.0
            err = abs(got[m] - want[m]) / scale
            held[m] = dict(cuda=got[m], cpu=want[m], err=err, tol=EV_TOL[m],
                           relative=m in EV_RELATIVE)
            log(f"  EV subset {m} CUDA vs CPU: {got[m]:.6g} / {want[m]:.6g}, "
                f"{'relative' if m in EV_RELATIVE else 'absolute'} {err:.3g} (tol {EV_TOL[m]})")
        out["cuda_vs_cpu"] = held
        bad = [m for m, h in held.items() if not h["err"] <= h["tol"]]
        if bad:
            raise AssertionError(f"EV subset: CUDA and CPU disagree on {bad}: {held}")
    return shapes


TINY_BLIP = dict(image_size=32, patch_size=16, vision_width=64, vision_layers=2,
                 vision_heads=2, text_width=64, text_layers=2, text_heads=2,
                 text_intermediate=128, vocab_size=300)
TINY_OPEN_CLIP = dict(vocab_size=1000, width=64, heads=2, layers=2, projection_dim=32)


def phase_tiny_ev(record):
    """Phase 3's metric encoders, CUDA against the CPU with the same float32
    weights (TF32 off), within TINY_TOL of max |ref|: InceptionV3-FID at its
    only width, batch 2 from 224^2; a tiny BLIP ImageReward (scores of two
    prompts under the hash tokenizer, one padded, so BERT's key mask and the
    cross-attention run through row 1 at head dim 32); a tiny OpenCLIPText
    (pooled at argmax(ids))."""
    import torch

    from freefine_tpu_torch.config import OpenCLIPTextConfig
    from freefine_tpu_torch.models.blip import BlipConfig, HashWordTokenizer, ImageReward
    from freefine_tpu_torch.models.inception import InceptionV3FID
    from freefine_tpu_torch.models.open_clip_text import OpenCLIPText
    from freefine_tpu_torch.models.tokenizer import HashTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = record.setdefault("tiny_ev", {})
    gen = torch.Generator().manual_seed(3)
    prompts = ["a red cup moved to the left", "a slightly rotated wooden chair by a window"]
    runs = (
        ("inception", lambda dev: InceptionV3FID(device=dev),
         lambda: (torch.randn(2, 224, 224, 3, generator=gen),)),
        ("blip_image_reward", lambda dev: ImageReward(BlipConfig(**TINY_BLIP), device=dev),
         lambda: (torch.randn(2, 32, 32, 3, generator=gen),
                  *(torch.as_tensor(np.stack(a)).long() for a in zip(
                      *(HashWordTokenizer(300).encode(p) for p in prompts))))),
        ("open_clip_text", lambda dev: OpenCLIPText(OpenCLIPTextConfig(**TINY_OPEN_CLIP),
                                                    device=dev),
         lambda: (torch.as_tensor(np.stack([HashTokenizer(1000).encode(p)
                                            for p in prompts])).long(),)),
    )
    for seed, (name, make, inputs) in enumerate(runs):
        cpu, gpu = _tiny_pair(make, 40 + seed)
        args = inputs()
        with torch.no_grad():
            want = cpu(*args)
            got = gpu(*(a.cuda() for a in args))
        if not want.abs().max() > 0:
            raise AssertionError(f"tiny EV {name}: zero output on the CPU")
        _held(out, name, got, want, label="EV")


def save_record(record, **extra):
    """The run's record so far, with `extra` beside it, to
    chiprun_out/chip_smoke.json (written again after each of the early
    phases, so that a later failure leaves their numbers behind)."""
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({**record, **extra}, f, indent=1, default=str)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-sd15", action="store_true",
                    help="skip phases 4 to 9b, 3D, SV3D, FLOW, MG, RD, DE, SG, GD, DH, DD, "
                         "G-XL and PX (kernel and tiny checks only)")
    ap.add_argument("--timed-runs", type=int, default=1,
                    help="timed edits or calls a timed phase runs after its warm-up")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one edit of each path (torch.profiler)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        sys.exit(2)
    from freefine_tpu_torch.ops import cuda_build

    record = {"argv": sys.argv[1:]}
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    record.update(card=card, torch=torch.__version__, cuda=torch.version.cuda)
    log(f"phase 1: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    record["build_s"] = time.perf_counter() - t0
    log(f"  built {sorted(p.name for p in libs.values())} in {record['build_s']:.1f} s")

    record["ptxas"] = ptxas_report(libs)
    record["flash_smem"] = flash_smem_report()
    wgmma_spills(record["ptxas"])
    record["flash_bwd_smem"] = bwd_smem_report(
        "flash_sdpa_bwd", ("flash_sdpa_bwd_dq", "flash_sdpa_bwd_dkv"))
    record["tca_bwd_smem"] = bwd_smem_report(
        "tca_flash_bwd", ("tca_flash_bwd_dq", "tca_flash_bwd_dkv"))

    record["gn_instantiations"] = gn_report(record["ptxas"])

    log("phase 2: kernels against their twins")
    checked = phase_kernels(record)
    save_record(record, phase2={name: rows for name, (rows, _) in checked.items()})
    log("phase 3: tiny config, CUDA vs CPU")
    phase_tiny(record)
    for model in ("xl", "dit", "pixart"):
        phase_tiny(record, model)
    phase_tiny_3d(record)
    phase_tiny_sv3d(record)
    phase_tiny_mg(record)
    phase_tiny_baselines(record)
    phase_tiny_dh_dd(record)
    phase_tiny_ev(record)
    counts = None
    if args.profile:  # the process's first profiler session: later ones can miss short calls
        log("phase 10 (before the profiled edits): group_norm_silu launches per call")
        gn_launches_per_call(checked["group_norm_silu"][0])
    if not args.skip_sd15:
        pipe, case, store = sd15_setup(record)
        log("phase 4: SD-1.5 512^2 edit (generation)")
        counts = {"generation": phase_sd15(record, pipe, case, store, args.timed_runs,
                                           args.profile)}
        log("phase 5: SD-1.5 512^2 energy-guided edit (guided_generation)")
        with fused_gn("0"):
            counts["guided"] = phase_guided(record, pipe, case, store, args.timed_runs,
                                            args.profile)
        log("phase 6: SD-1.5 512^2 object removal (background_generation)")
        counts["bggen"] = phase_bggen(record, pipe, case, store, args.timed_runs, args.profile)
        log("phase 7: SD-1.5 512^2 composition of 2 sources (cross_image_composition)")
        counts["compose"] = phase_compose(record, pipe, case, store, args.timed_runs,
                                          args.profile)
        log("phase 8: SD-1.5 512^2 differentiated TCA edit pass (tca_flash_diff)")
        with fused_gn("0"):
            counts["D"] = phase_tca_grad(record, pipe, case)
        log(f"phase 9: SD-1.5 512^2 batched lanes (shared source at batch {BATCH_SHARED}, "
            f"per case at batch {BATCH_CASES})")
        counts["S"], counts["B"] = phase_batched(record, pipe, store, args.timed_runs,
                                                 args.profile)
        log("phase 9b: SD-1.5 512^2 checkpoint round trip, off-size input, intermediates, "
            "attention probe, GroupNorm default")
        gn_default = phase_rest(record, pipe, case, store)
        log("phase 3D: SD-1.5 512^2 depth-based 3D edit (EfficientSAM box mask, Depth-Anything "
            "depth, point-splat coarse edit, GeoBench-3D warp, generation at the 3D protocol)")
        counts["3D"] = phase_3d(record, pipe, store, args.timed_runs, args.profile)
        log("phase SV3D: the SV3D coarse 3D edit (video UNet orbit of 21 frames at 576^2, "
            "ViT-H token, U^2-Net matting), then generation at the 3D protocol")
        counts["SV3D"] = phase_sv3d(record, pipe, store, args.timed_runs, args.profile)
        log("phase FLOW: RAFT between two 512^2 images (forward, forward and backward), one "
            "DIFT featurisation")
        raft, counts["DIFT"] = phase_flow(record, pipe, args.timed_runs)
        log(f"phase MG: MotionGuidance.edit on the SD-1.5 512^2 pipe, {MG_STEPS} steps x "
            f"{MG_RECURSIVE} recursive steps")
        counts["MG"] = phase_mg(record, pipe, raft, store)
        del raft
        log("phase RD: RegionDrag.drag_regions on the SD-1.5 512^2 pipe (50 steps, start 0.5, "
            "end 0.2)")
        counts["RD"] = phase_rd(record, pipe, store, args.timed_runs)
        log("phase DE: DesignEdit.move on the SD-1.5 512^2 pipe (50 steps, CFG 7.5)")
        counts["DE"] = phase_de(record, pipe, store, args.timed_runs)
        log(f"phase SG: SelfGuidance.edit on the SD-1.5 512^2 pipe ({GRADIENT_BASELINE_STEPS} "
            "of the protocol's 50 steps, CFG 7.5, inversion 1.5, weight 15)")
        counts["SG"] = phase_sg(record, pipe, store)
        log(f"phase GD: GeoDiffuser.edit on the SD-1.5 512^2 pipe ({GRADIENT_BASELINE_STEPS} "
            "of the protocol's 50 steps, lr 0.03)")
        counts["GD"] = phase_gd(record, pipe, store)
        log("phase DH: DiffusionHandles.edit on the SD-1.5 512^2 pipe (50 steps, null-text "
            "inversion cut to 2 a step, 1 latent step a guided step to step 38; "
            "Depth-Anything's depth)")
        counts["DH"] = phase_dh(record, pipe, store)
        log("phase DD: DragDiffusion.drag on the SD-1.5 512^2 pipe (LoRA rank 16 cut to 20 "
            "steps; inversion 0.7, at most 20 drag iterations, MasaCtrl denoise)")
        counts["DD"] = phase_dd(record, pipe, store)
        del pipe, case, store
        gc.collect()
        torch.cuda.empty_cache()
        log("phase G-XL: SDXL 1024^2 edit (SDXLFreeFine.generation)")
        counts["XL"] = phase_sdxl(record, args.timed_runs, args.profile)
        log("phase PX: PixArt 512^2 edit (FreeFine.generation on the DiT, T5-XXL captions)")
        counts["PX"] = phase_pixart(record, args.timed_runs, args.profile)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase EV: GeoBench's scoring (metrics.main, task {EV_TASK}: every metric but MD) "
            f"of {EV_IMAGES * EV_CASES} edits at {EV_SIDE}^2 against {EV_REAL} real images")
        counts["EV"] = phase_ev(record)
    if not args.profile:
        log("phase 10: group_norm_silu launches per call at every path shape (profiled last)")
        gn_launches_per_call(checked["group_norm_silu"][0])
    # the GroupNorm kernel also over phase 9b's E and D under the default
    gn_counts = None if counts is None else {
        **counts, **{f"{path}_gn_default": sh for path, sh in gn_default.items()}}
    kernels = [summarize(name, source, replaces, *checked[name],
                         gn_counts if name == "group_norm_silu" else counts)
               for name, _, _, _, source, replaces in KERNELS]
    record["kernels"] = kernels
    record["seconds"] = time.perf_counter() - t0

    save_record(record)
    print(json.dumps({"kernels": [{k: v for k, v in r.items() if k not in ("shapes", "checks")}
                                  for r in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
