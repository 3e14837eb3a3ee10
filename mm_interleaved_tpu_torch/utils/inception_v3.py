"""InceptionV3 pool3 features for FID (counterpart of
`mm_interleaved_tpu/utils/inception_v3.py`).

pytorch-FID's InceptionV3 (torchvision's, with the max-pooled last block),
written out here: the machine with the card has no torchvision.  The
module names are torchvision's (``Mixed_5b.branch1x1.conv``, ``.bn``), so
`convert_torchvision_inception` is a name map of the tensors as they are,
the classifier (``fc``), the auxiliary head (``AuxLogits``) and the batch
counters skipped.  The public function takes NHWC images in [0, 1], as the
JAX module does: resized to 299 x 299 (bilinear, half-pixel centres,
antialiased when shrinking, as ``jax.image.resize``), scaled to [-1, 1],
2048 features out.  Convolutions and pools run NCHW inside.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from .name_map import NameMap, same

INCEPTION_SKIPS = (r"^AuxLogits\.", r"^fc\.", r"num_batches_tracked$")


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg3(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        # pytorch-FID's last block pools by max
        bp = (_avg3(x) if self.pool == "avg"
              else F.max_pool2d(x, 3, stride=1, padding=1))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3Features(nn.Module):
    """``[B, H, W, 3]`` in [0, 1] -> pool3 features ``[B, 2048]``."""

    def __init__(self, resize_input: bool = True,
                 fid_final_block: bool = True):
        super().__init__()
        self.resize_input = resize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max" if fid_final_block else "avg")

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2).to(self.Conv2d_1a_3x3.conv.weight.dtype)
        if self.resize_input and tuple(x.shape[2:]) != (299, 299):
            x = F.interpolate(x, size=(299, 299), mode="bilinear",
                              align_corners=False,
                              antialias=min(x.shape[2:]) > 299)
        x = x * 2.0 - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def inception_tensors(model: InceptionV3Features) -> Sequence[Tuple[str, torch.Tensor]]:
    """What a converter fills: the parameters and the batch norms' running
    statistics."""
    return [(n, t) for n, t in model.state_dict(keep_vars=True).items()
            if not n.endswith("num_batches_tracked")]


def convert_torchvision_inception(model: InceptionV3Features) -> NameMap:
    """torchvision's ``inception_v3`` state dict (the FID weights file
    ``pt_inception-2015-12-05`` has the same layout) -> ``model``: every
    tensor as it is; `INCEPTION_SKIPS` names what is not read."""
    return {n: same(n) for n, _ in inception_tensors(model)}
