"""The torchvision ResNet zoo of ``MODEL.ARCH``, with ``vil_tpu``'s BatchNorm.

Counterpart of ``vil_tpu/models/resnet.py``: the v1.5 graph (the stride on
the bottleneck's 3×3 convolution), conv7×7/2 → bn → relu → maxpool3×3/2 →
four stages → global average pool → fc, for the nine names of
:data:`RESNET_ZOO`. The module and parameter names are torchvision's
(``layer1.0.conv1.weight``, ``layer1.0.downsample.0/1``, ``fc``), so a
torchvision ``state_dict`` loads as it is (``utils.torch_import``, which
truncates the head rows), and ``utils.jax_import`` maps ``vil_tpu``'s flax
tree onto them (``layerI_J`` → ``layerI.J``, ``downsample_conv/bn`` →
``downsample.0/1``, HWIO → OIHW, ``batch_stats`` → the running buffers).

Images are NHWC, f32 or uint8 (normalised on the device, as in
``PatchEmbed``), and the network computes in channels-last layout: the NHWC
input viewed as NCHW, each convolution's output in the same layout.
Convolutions run through ``F.conv2d`` (cuDNN on the card): ``vil_tpu``
computes them in XLA, outside any Pallas kernel. Parameters are kept in
``param_dtype`` (f32) and cast to ``dtype``, the compute type, where they
are used; the logits are f32, as the JAX package's are.

:class:`BatchNorm` is flax's ``nn.BatchNorm`` as ``vil_tpu`` configures it,
in plain PyTorch (``vil_tpu``'s is XLA): f32 statistics, the variance as
E[x²] − E[x]² clipped at 0, the biased batch variance into
``running_var`` with flax's momentum 0.9 (torch's 0.1), eps 1e-5, and the
running statistics in eval. ``torch.nn.BatchNorm2d`` keeps the unbiased
variance and so cannot stand in for it. Under ``jit`` ``vil_tpu`` takes the
statistics of the global batch over the whole image; with a ``group`` (the
ranks of the data axis, and of the spatial axis where the image's rows are
split) the per-channel sums and the element count are all-reduced over it,
forward and backward (``parallel.tensor.sum_over``), for the same
statistics, whatever share of the rows each rank holds.

On a spatial axis (``forward(x, spatial=ctx)``, ``vil_tpu``'s
``P('data', 'spatial')`` images under GSPMD) each rank holds whole blocks of
:data:`ROW_BLOCK` image rows, the net's total stride
(:meth:`ResNet.spatial_split`), so that its rows at every resolution are one
contiguous block and no stride-2 layer straddles a cut. Each convolution
and the max-pool read their halo rows from the neighbouring ranks and the
padding value at the image's edges (``parallel.spatial.ConvRows``), and run
with padding along the columns alone; the global pool sums the rank's
positions, reduces the sum over the spatial group and divides by the whole
image's, so that ``fc`` and the logits are the same on every rank.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.spatial import ConvRows, RowSplit, block_split, reduce_sum
from ..parallel.tensor import sum_over
from ..utils.device import resolve_device
from .layers import Conv2d, Linear

# name → constructor keywords, torchvision's classification zoo
RESNET_ZOO = {
    "resnet18": dict(layers=(2, 2, 2, 2), bottleneck=False),
    "resnet34": dict(layers=(3, 4, 6, 3), bottleneck=False),
    "resnet50": dict(layers=(3, 4, 6, 3)),
    "resnet101": dict(layers=(3, 4, 23, 3)),
    "resnet152": dict(layers=(3, 8, 36, 3)),
    "resnext50_32x4d": dict(layers=(3, 4, 6, 3), groups=32, base_width=4),
    "resnext101_32x8d": dict(layers=(3, 4, 23, 3), groups=32, base_width=8),
    "wide_resnet50_2": dict(layers=(3, 4, 6, 3), base_width=128),
    "wide_resnet101_2": dict(layers=(3, 4, 23, 3), base_width=128),
}
# image rows a rank holds whole blocks of on a spatial axis: the total stride
# (stem 2, max-pool 2, three stride-2 stages)
ROW_BLOCK = 32


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels
    of an NCHW tensor (any memory layout), the module docstring's semantics.
    ``weight`` / ``bias`` are flax's ``scale`` / ``bias``; ``running_mean`` /
    ``running_var`` (f32 buffers) its ``batch_stats`` ``mean`` / ``var``.
    ``group``: the process group whose ranks' batches (and rows) make the
    statistics' batch, ``group_size`` its ranks (1: this process's batch
    alone). The element count is summed with Σx and Σx², so that ranks
    holding unequal shares of the rows weigh by what they hold."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5, device=None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, group=None, group_size: int = 1):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.compute_dtype = dtype
        self.group, self.group_size = group, group_size
        self.weight = nn.Parameter(torch.ones(channels, device=device, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(channels, device=device, dtype=param_dtype))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # at least f32, as flax's
        shape = (1, -1, 1, 1)
        if self.training:
            dims = (0, 2, 3)
            sums = torch.stack([xf.sum(dims), (xf * xf).sum(dims)])  # (2, C): Σx, Σx²
            count = xf.numel() // xf.shape[1]
            if self.group_size > 1:  # the global batch's sums and count
                total = sum_over(torch.cat([sums.reshape(-1), sums.new_tensor([count])]),
                                 self.group)
                sums, count = total[:-1].view(2, -1), total[-1]
            mean, mean_sq = sums[0] / count, sums[1] / count
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.to(xf.dtype).view(shape)
        return y.to(self.compute_dtype)


class HaloConv2d(Conv2d):
    """:class:`~.layers.Conv2d` that also runs on a rank's rows: given the
    rows' :class:`~vil_tpu_torch.parallel.spatial.ConvRows`, it reads its
    halo rows (zeros at the image's edges) and convolves with padding along
    the columns alone."""

    def forward(self, x: torch.Tensor, rows: Optional[ConvRows] = None) -> torch.Tensor:
        if rows is None:
            return super().forward(x)
        (k, _), (s, _), (p, pw) = self.kernel_size, self.stride, self.padding
        dt = self.compute_dtype
        x = rows.window(x.to(dt), k, s, p)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x, self.weight.to(dt), bias, self.stride, (0, pw), self.dilation,
                        self.groups)

    def rows_after(self, rows: Optional[ConvRows]) -> Optional[ConvRows]:
        """The output's rows of input ``rows`` (None stays None)."""
        if rows is None:
            return None
        return rows.after(self.kernel_size[0], self.stride[0], self.padding[0])


def max_pool(x: torch.Tensor, rows: Optional[ConvRows] = None) -> torch.Tensor:
    """The stem's 3×3 stride-2 max-pool, padded by 1 (−inf, as
    ``F.max_pool2d`` pads); on a rank's rows its halo rows first."""
    if rows is None:
        return F.max_pool2d(x, 3, stride=2, padding=1)
    return F.max_pool2d(rows.window(x, 3, 2, 1, float("-inf")), 3, stride=2, padding=(0, 1))


class Stage(nn.Sequential):
    """One stage's blocks, in torchvision's ``layerN.J`` names; on a rank's
    rows each block takes and returns its rows."""

    def forward(self, x: torch.Tensor, rows: Optional[ConvRows] = None):
        for block in self:
            x, rows = block(x, rows)
        return x, rows


class Block(nn.Module):
    """BasicBlock (expansion 1) or Bottleneck (expansion 4), torchvision's
    names: conv1/bn1, conv2/bn2 (, conv3/bn3), ``downsample`` (conv, bn).
    ``forward(x, rows)`` returns the output and its rows (None unsplit)."""

    def __init__(self, in_planes: int, planes: int, stride: int, bottleneck: bool,
                 downsample: bool, groups: int = 1, base_width: int = 64, **kw):
        super().__init__()
        bn_kw = {k: v for k, v in kw.items() if k not in ("group", "group_size")}
        conv = lambda i, o, k, s, g=1: HaloConv2d(i, o, k, stride=s, bias=False,
                                                  padding=k // 2, groups=g, **bn_kw)
        self.bottleneck = bottleneck
        if bottleneck:
            width = int(planes * (base_width / 64.0)) * groups
            out = planes * 4
            self.conv1, self.bn1 = conv(in_planes, width, 1, 1), BatchNorm(width, **kw)
            self.conv2 = conv(width, width, 3, stride, groups)
            self.bn2 = BatchNorm(width, **kw)
            self.conv3, self.bn3 = conv(width, out, 1, 1), BatchNorm(out, **kw)
        else:
            out = planes
            self.conv1, self.bn1 = conv(in_planes, planes, 3, stride), BatchNorm(planes, **kw)
            self.conv2, self.bn2 = conv(planes, planes, 3, 1), BatchNorm(planes, **kw)
        self.downsample = (nn.Sequential(conv(in_planes, out, 1, stride), BatchNorm(out, **kw))
                           if downsample else None)

    def forward(self, x: torch.Tensor, rows: Optional[ConvRows] = None):
        out = F.relu(self.bn1(self.conv1(x, rows)))
        mid = self.conv1.rows_after(rows)
        out = self.bn2(self.conv2(out, mid))
        end = self.conv2.rows_after(mid)
        if self.bottleneck:
            out = self.bn3(self.conv3(F.relu(out), end))
        identity = x
        if self.downsample is not None:
            conv, bn = self.downsample
            identity = bn(conv(x, rows))
        return F.relu(out + identity), end


class ResNet(nn.Module):
    """torchvision-graph ResNet: NHWC images (B, H, W, 3), f32 or uint8, →
    (B, num_classes) f32 logits. ``forward`` takes the training step's
    ``generator`` and ``mode`` and ignores them, as ``vil_tpu``'s takes
    ``mode``. Built on the CUDA card unless ``device`` names another;
    weights drawn by :meth:`init_weights` from ``generator``. ``group`` /
    ``group_size``: the process group of the ranks that hold different
    images or rows (the data axis, with the spatial axis where the mesh has
    one), over which every BatchNorm takes the global batch's statistics
    (:class:`BatchNorm`); on a model axis the model ranks run the whole net
    on the same images and rows. FSDP slices its large convolution weights
    over the data axis like any other leaf (``parallel.fully_shard``).
    ``img_size``: the image rows a spatial split cuts (``INPUT.IMAGE_SIZE``;
    only the split reads it)."""

    def __init__(self, layers: Sequence[int], num_classes: int = 1000, bottleneck: bool = True,
                 groups: int = 1, base_width: int = 64, device=None,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32,
                 input_mean: tuple = (0.485, 0.456, 0.406),
                 input_std: tuple = (0.229, 0.224, 0.225),
                 generator: Optional[torch.Generator] = None, group=None, group_size: int = 1,
                 img_size: Optional[int] = None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype, param_dtype=param_dtype)
        bn = dict(kw, group=group, group_size=group_size)
        self.dtype = dtype
        self.img_size = img_size
        self.param_shards: dict = {}  # no tp cut; FSDP adds its slices (fully_shard)
        self.conv1 = HaloConv2d(3, 64, 7, stride=2, bias=False, padding=3, **kw)
        self.bn1 = BatchNorm(64, **bn)
        expansion = 4 if bottleneck else 1
        in_planes = 64
        for stage, nblocks in enumerate(layers):
            planes = 64 * 2 ** stage
            blocks = []
            for j in range(nblocks):
                stride = 2 if stage > 0 and j == 0 else 1
                down = j == 0 and (stride != 1 or in_planes != planes * expansion)
                blocks.append(Block(in_planes, planes, stride, bottleneck, down, groups,
                                    base_width, **bn))
                in_planes = planes * expansion
            setattr(self, f"layer{stage + 1}", Stage(*blocks))
        self.num_stages = len(layers)
        self.fc = Linear(in_planes, num_classes, **kw)
        mean = np.asarray(input_mean, np.float32)
        std = np.asarray(input_std, np.float32)
        self._u8_scale = (1.0 / (255.0 * std)).tolist()
        self._u8_offset = (-mean / std).tolist()
        self.init_weights(generator)
        self.to(memory_format=torch.channels_last)

    def spatial_split(self, size: int) -> RowSplit:
        """The split of the ``img_size`` image rows over ``size`` ranks in
        whole blocks of :data:`ROW_BLOCK` rows, the first ranks taking one
        more, the last any remainder and the bottom edge (``image``; no
        chunked stage). Raises ``ValueError`` when a rank would hold no
        block."""
        if self.img_size is None:
            raise ValueError("a ResNet split by rows needs its img_size (INPUT.IMAGE_SIZE)")
        image = block_split(self.img_size, ROW_BLOCK, size)
        if any(hi <= lo for lo, hi in image):
            raise ValueError(f"spatial parallelism over {size} ranks leaves a rank no row: the "
                             f"image's {self.img_size} rows split into "
                             f"{-(-self.img_size // ROW_BLOCK)} blocks of {ROW_BLOCK} (the "
                             f"net's total stride), fewer than the ranks")
        return RowSplit(image, (), ())

    def partial_over_model(self) -> list:
        """None of the parameters: on a model axis every rank holds the
        whole ResNet and its whole gradient (``MsViT.partial_over_model``),
        beside a spatial axis its rows' part, which the spatial sum makes
        whole."""
        return []

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's initialisers, as ``vil_tpu``'s modules take them: the
        convolutions' and fc's kernels LeCun-normal (truncated at ±2σ, unit
        variance after the cut), biases 0, BatchNorm scales 1. Drawn in f32
        on the CPU from ``generator``, then copied, so one seed gives the
        same weights on any device."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)) and not mod.weight.is_meta:
                fan_in = math.prod(mod.weight.shape[1:])
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                t = torch.empty(mod.weight.shape, dtype=torch.float32)
                nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)
                mod.weight.copy_(t)
                if mod.bias is not None:
                    mod.bias.zero_()

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                mode=0, spatial=None) -> torch.Tensor:
        """x: (B, H, W, 3) NHWC images, or with a ``spatial`` context (a
        ``parallel.SpatialContext``) this rank's rows of them
        (``parallel.shard_image``); the logits are the same on every rank of
        the group."""
        rows = None
        if spatial is not None:
            rows = ConvRows(self.spatial_split(spatial.size).image, self.img_size, spatial)
        dt = self.dtype
        if x.dtype == torch.uint8:
            scale = torch.tensor(self._u8_scale, dtype=dt, device=x.device)
            offset = torch.tensor(self._u8_offset, dtype=dt, device=x.device)
            x = x.to(dt) * scale + offset
        x = x.to(dt).permute(0, 3, 1, 2)  # NHWC viewed as NCHW: channels-last
        x = F.relu(self.bn1(self.conv1(x, rows)))
        rows = self.conv1.rows_after(rows)
        x = max_pool(x, rows)
        rows = rows if rows is None else rows.after(3, 2, 1)
        for stage in range(self.num_stages):
            x, rows = getattr(self, f"layer{stage + 1}")(x, rows)
        x = x.to(torch.promote_types(x.dtype, torch.float32))  # at least f32
        if rows is None:
            x = x.mean(dim=(2, 3))  # global average pool
        else:  # this rank's positions summed, over the group, over the whole image's
            x = reduce_sum(x.sum(dim=(2, 3)), spatial) / (rows.total * x.shape[3])
        return self.fc(x.to(dt)).float()


def build_resnet(name: str, num_classes: int, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None, **overrides) -> ResNet:
    """The zoo model ``name`` (:data:`RESNET_ZOO`); ``overrides`` replace its
    keywords (``layers=(1, 1, 1, 1)``) or add ResNet's others."""
    kwargs = dict(RESNET_ZOO[name])
    kwargs.update(overrides)
    return ResNet(num_classes=num_classes, dtype=dtype, param_dtype=param_dtype, device=device,
                  **kwargs)
