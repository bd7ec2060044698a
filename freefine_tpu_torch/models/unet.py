"""SD UNet2DCondition in PyTorch with editing hooks (mirrors
`freefine_tpu.models.unet`).

Module names are diffusers' (conv_in, time_embedding, down_blocks,
mid_block, up_blocks, conv_norm_out, conv_out).  Transformer blocks carry
``block_index`` in execution order (down 0-5, mid 6, up 7-15 for SD-1.5),
advanced by each transformer's depth exactly as the JAX module does; the
TCA layer range gates on it.  forward() takes NCHW.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from freefine_tpu_torch.config import UNetConfig
from freefine_tpu_torch.edit import EditConfig, EditState, none_config
from freefine_tpu_torch.models.layers import (
    Downsample2D,
    EditAttention,
    GroupNorm32,
    ResnetBlock2D,
    SpatialTransformer,
    TimestepEmbedding,
    Upsample2D,
)


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNetConfig, device=None):
        super().__init__()
        cfg = self.config = config
        dt, dev = cfg.dtype, device
        ch = cfg.block_out_channels
        nb = len(ch)
        temb_ch = ch[0] * 4
        g = cfg.norm_num_groups

        def transformer(c, level):
            return SpatialTransformer(c, cfg.cross_attention_dim, cfg.heads(level), g,
                                      cfg.transformer_depth[level], dt, dev,
                                      use_linear=cfg.use_linear_projection)

        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1, dtype=dt, device=dev)
        self.time_embedding = TimestepEmbedding(ch[0], temb_ch, cfg.flip_sin_to_cos,
                                                cfg.freq_shift, dt, dev)
        if cfg.addition_embed_dim is not None:  # SDXL: add_embedding over added_cond
            self.add_embedding = nn.Module()
            self.add_embedding.linear_1 = nn.Linear(cfg.addition_embed_dim, temb_ch, dtype=dt,
                                                    device=dev)
            self.add_embedding.linear_2 = nn.Linear(temb_ch, temb_ch, dtype=dt, device=dev)
        skip_ch = [ch[0]]
        prev = ch[0]
        self.down_blocks = nn.ModuleList()
        for i, out_ch in enumerate(ch):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            if cfg.down_block_has_attn[i]:
                blk.attentions = nn.ModuleList()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock2D(prev, out_ch, temb_ch, g, 1e-5, True, dt, dev))
                prev = out_ch
                if cfg.down_block_has_attn[i]:
                    blk.attentions.append(transformer(out_ch, i))
                skip_ch.append(out_ch)
            if i < nb - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(out_ch, "symmetric", dt, dev)])
                skip_ch.append(out_ch)
            self.down_blocks.append(blk)

        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([
            ResnetBlock2D(ch[-1], ch[-1], temb_ch, g, 1e-5, True, dt, dev) for _ in range(2)
        ])
        self.mid_block.attentions = nn.ModuleList([transformer(ch[-1], nb - 1)])

        rev = list(reversed(ch))
        self.up_blocks = nn.ModuleList()
        prev = ch[-1]
        for i, out_ch in enumerate(rev):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            has_attn = cfg.up_block_has_attn[i]
            if has_attn:
                blk.attentions = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(
                    ResnetBlock2D(prev + skip_ch.pop(), out_ch, temb_ch, g, 1e-5, True, dt, dev)
                )
                prev = out_ch
                if has_attn:
                    blk.attentions.append(transformer(out_ch, nb - 1 - i))
            if i < nb - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(out_ch, dt, dev)])
            self.up_blocks.append(blk)

        self.conv_norm_out = GroupNorm32(g, ch[0], 1e-5, dev)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1, dtype=dt, device=dev)
        for name, mod in self.named_modules():
            if isinstance(mod, EditAttention):
                mod.path = tuple(name.split("."))

    def forward(
        self,
        sample: torch.Tensor,
        timestep,
        encoder_hidden_states: torch.Tensor,
        *,
        edit_cfg: EditConfig = none_config(),
        edit_state: Optional[EditState] = None,
        return_features: bool = False,
        context_extra: Optional[torch.Tensor] = None,
        added_cond: Optional[torch.Tensor] = None,
        context_image: Optional[torch.Tensor] = None,
    ):
        """sample [B, C, H, W]; timestep int, 0-d or [B]; context [B, L, D];
        context_extra optional [P, L, D] compose region prompts (their K/V
        feed the conditional edit stream's cross-attention); added_cond
        [B, addition_embed_dim] the SDXL added conditioning (pooled text ++
        time ids), required where the config has addition_embed_dim;
        context_image [B, T, D] IP-Adapter image tokens, read by every
        cross-attention where `edit_cfg.ip_scale > 0`.
        Returns the noise prediction [B, C_out, H, W] in the model dtype;
        with return_features, (eps, [mid, up_0, .., up_{n-1}]): the mid-block
        output and each up block's output after its upsampler (NCHW), the
        feature taps of energy guidance (JAX `return_features`).  Under
        `edit_cfg.sow_token_attn` the output of up_blocks[-1].resnets[-2]
        (NCHW) is added to `edit_state.intermediates` under
        ("guidance_feature",), SelfGuidance's appearance tap."""
        cfg = self.config
        dt = cfg.dtype
        sample = sample.to(dt)
        context = encoder_hidden_states.to(dt)
        if context_extra is not None:
            context_extra = context_extra.to(dt)
        t = torch.as_tensor(timestep, device=sample.device)
        if t.ndim == 0:
            t = t.expand(sample.shape[0])
        temb = self.time_embedding(t)
        if cfg.addition_embed_dim is not None:
            if added_cond is None:
                raise ValueError("this UNet config needs added_cond (SDXL added conditioning)")
            a = self.add_embedding
            temb = temb + a.linear_2(F.silu(a.linear_1(added_cond.to(dt))))
        nb = len(cfg.block_out_channels)
        attn_index = 0
        ekw = dict(edit_cfg=edit_cfg, edit_state=edit_state, context_extra=context_extra,
                   context_image=context_image)

        h = self.conv_in(sample)
        skips = [h]
        for i, blk in enumerate(self.down_blocks):
            for j, res in enumerate(blk.resnets):
                h = res(h, temb)
                if cfg.down_block_has_attn[i]:
                    h = blk.attentions[j](h, context, block_index=attn_index, place="down", **ekw)
                    attn_index += cfg.transformer_depth[i]
                skips.append(h)
            if i < nb - 1:
                h = blk.downsamplers[0](h)
                skips.append(h)

        h = self.mid_block.resnets[0](h, temb)
        h = self.mid_block.attentions[0](h, context, block_index=attn_index, place="mid", **ekw)
        attn_index += cfg.transformer_depth[nb - 1]
        h = self.mid_block.resnets[1](h, temb)
        features = [h]

        for i, blk in enumerate(self.up_blocks):
            level = nb - 1 - i
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if edit_cfg.sow_token_attn and i == nb - 1 and j == cfg.layers_per_block - 1:
                    # SelfGuidance's appearance tap, up_blocks[-1].resnets[-2]
                    edit_state.intermediates.setdefault(("guidance_feature",), []).append(h)
                if cfg.up_block_has_attn[i]:
                    h = blk.attentions[j](h, context, block_index=attn_index, place="up", **ekw)
                    attn_index += cfg.transformer_depth[level]
            if i < nb - 1:
                h = blk.upsamplers[0](h)
            features.append(h)

        h = self.conv_norm_out(h, silu=True)
        out = self.conv_out(h)
        return (out, features) if return_features else out
