"""InceptionV3 of pytorch-fid in PyTorch (mirrors
`freefine_tpu.models.inception`): the FID feature extractor.

torchvision's inception_v3 with the FID changes: the branch average pools
leave the padding out of the count (Mixed_5b-7b), Mixed_7c's pool branch is
a max pool, and the output is the 2048-d mean pool.  An input that is not
299^2 is upsampled inside the model (bilinear, align_corners=False, no
antialias, as pytorch-fid's resize_input), then scaled to [-1, 1].  The
BatchNorms run in inference form over their running statistics, eps 1e-3.

Module names are torchvision's (`Conv2d_1a_3x3.conv`, `.bn`,
`Mixed_5b.branch1x1`, ...), the layout of pytorch-fid's
pt_inception-2015-12-05 weights that `weights.load_inception_fid` reads.
The forward takes NHWC, as the JAX module does, and runs NCHW inside.
No kernel of the port runs here: convolutions and pools are cuDNN's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from freefine_tpu_torch.models.layers import FrozenBatchNorm2d


class BNConv(nn.Module):
    """Conv2d without bias, BatchNorm (eps 1e-3, inference), ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0, device=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False,
                              device=device)
        self.bn = FrozenBatchNorm2d(cout, eps=1e-3, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_noinc(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, device=None):
        super().__init__()
        self.branch1x1 = BNConv(cin, 64, 1, device=device)
        self.branch5x5_1 = BNConv(cin, 48, 1, device=device)
        self.branch5x5_2 = BNConv(48, 64, 5, padding=2, device=device)
        self.branch3x3dbl_1 = BNConv(cin, 64, 1, device=device)
        self.branch3x3dbl_2 = BNConv(64, 96, 3, padding=1, device=device)
        self.branch3x3dbl_3 = BNConv(96, 96, 3, padding=1, device=device)
        self.branch_pool = BNConv(cin, pool_features, 1, device=device)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool_noinc(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int, device=None):
        super().__init__()
        self.branch3x3 = BNConv(cin, 384, 3, stride=2, device=device)
        self.branch3x3dbl_1 = BNConv(cin, 64, 1, device=device)
        self.branch3x3dbl_2 = BNConv(64, 96, 3, padding=1, device=device)
        self.branch3x3dbl_3 = BNConv(96, 96, 3, stride=2, device=device)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, device=None):
        super().__init__()
        kw = dict(device=device)
        self.branch1x1 = BNConv(cin, 192, 1, **kw)
        self.branch7x7_1 = BNConv(cin, c7, 1, **kw)
        self.branch7x7_2 = BNConv(c7, c7, (1, 7), padding=(0, 3), **kw)
        self.branch7x7_3 = BNConv(c7, 192, (7, 1), padding=(3, 0), **kw)
        self.branch7x7dbl_1 = BNConv(cin, c7, 1, **kw)
        self.branch7x7dbl_2 = BNConv(c7, c7, (7, 1), padding=(3, 0), **kw)
        self.branch7x7dbl_3 = BNConv(c7, c7, (1, 7), padding=(0, 3), **kw)
        self.branch7x7dbl_4 = BNConv(c7, c7, (7, 1), padding=(3, 0), **kw)
        self.branch7x7dbl_5 = BNConv(c7, 192, (1, 7), padding=(0, 3), **kw)
        self.branch_pool = BNConv(cin, 192, 1, **kw)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool_noinc(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int, device=None):
        super().__init__()
        kw = dict(device=device)
        self.branch3x3_1 = BNConv(cin, 192, 1, **kw)
        self.branch3x3_2 = BNConv(192, 320, 3, stride=2, **kw)
        self.branch7x7x3_1 = BNConv(cin, 192, 1, **kw)
        self.branch7x7x3_2 = BNConv(192, 192, (1, 7), padding=(0, 3), **kw)
        self.branch7x7x3_3 = BNConv(192, 192, (7, 1), padding=(3, 0), **kw)
        self.branch7x7x3_4 = BNConv(192, 192, 3, stride=2, **kw)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, use_max_pool: bool, device=None):
        super().__init__()
        kw = dict(device=device)
        self.use_max_pool = use_max_pool
        self.branch1x1 = BNConv(cin, 320, 1, **kw)
        self.branch3x3_1 = BNConv(cin, 384, 1, **kw)
        self.branch3x3_2a = BNConv(384, 384, (1, 3), padding=(0, 1), **kw)
        self.branch3x3_2b = BNConv(384, 384, (3, 1), padding=(1, 0), **kw)
        self.branch3x3dbl_1 = BNConv(cin, 448, 1, **kw)
        self.branch3x3dbl_2 = BNConv(448, 384, 3, padding=1, **kw)
        self.branch3x3dbl_3a = BNConv(384, 384, (1, 3), padding=(0, 1), **kw)
        self.branch3x3dbl_3b = BNConv(384, 384, (3, 1), padding=(1, 0), **kw)
        self.branch_pool = BNConv(cin, 192, 1, **kw)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = F.max_pool2d(x, 3, stride=1, padding=1) if self.use_max_pool \
            else _avg_pool_noinc(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3FID(nn.Module):
    """[B, h, w, 3] (NHWC, ImageNet-normalised, as `fid_input_transform`
    gives it) -> [B, 2048] pool3 features."""

    def __init__(self, device=None):
        super().__init__()
        kw = dict(device=device)
        self.Conv2d_1a_3x3 = BNConv(3, 32, 3, stride=2, **kw)
        self.Conv2d_2a_3x3 = BNConv(32, 32, 3, **kw)
        self.Conv2d_2b_3x3 = BNConv(32, 64, 3, padding=1, **kw)
        self.Conv2d_3b_1x1 = BNConv(64, 80, 1, **kw)
        self.Conv2d_4a_3x3 = BNConv(80, 192, 3, **kw)
        self.Mixed_5b = InceptionA(192, 32, **kw)
        self.Mixed_5c = InceptionA(256, 64, **kw)
        self.Mixed_5d = InceptionA(288, 64, **kw)
        self.Mixed_6a = InceptionB(288, **kw)
        self.Mixed_6b = InceptionC(768, 128, **kw)
        self.Mixed_6c = InceptionC(768, 160, **kw)
        self.Mixed_6d = InceptionC(768, 160, **kw)
        self.Mixed_6e = InceptionC(768, 192, **kw)
        self.Mixed_7a = InceptionD(768, **kw)
        self.Mixed_7b = InceptionE(1280, False, **kw)
        self.Mixed_7c = InceptionE(2048, True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().permute(0, 3, 1, 2)
        if x.shape[2:] != (299, 299):
            x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                              antialias=False)
        x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        return x.mean(dim=(2, 3))
