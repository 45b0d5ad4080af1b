"""ResNet family, NCHW, with the reference's initialization recipe.

Port of ``stochastic_gradient_push_tpu/models/resnet.py`` (``ResNet``,
``BasicBlock``, ``Bottleneck``, ``resnet18/34/50/101/152``, ``RESNETS``)
as ``nn.Module``s over NCHW batches.  Names follow torchvision (``conv1``,
``bn1``, ``layer{i}.{j}.conv1``, ``.downsample.{0,1}``, ``fc``), so
ResNet-50 has torchvision's 25,557,032 parameters; ``models/convert.py``
maps them to the flax tree's auto-names.

Semantics kept from flax, where torch's defaults differ:

* **SAME padding.**  A 3x3 stride-2 convolution on an even input pads
  (0, 1) in flax, where ``padding=1`` would pad (1, 1) and shift every
  later activation.  :class:`Conv2d` computes flax's ``SAME`` pads from
  the input's size and pads explicitly where they are not symmetric.
  The 7x7 stem pads (3, 3) and the max-pool (1, 1) with -inf in both.
* **BatchNorm statistics.**  :class:`BatchNorm` takes the biased batch
  variance ``E[x^2] - E[x]^2`` in fp32, clamped at 0, feeds that same
  variance into the running-variance EMA (momentum 0.9, eps 1e-5) and
  normalizes as ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.  The
  new running statistics are returned through the forward's
  ``stats_out`` dict, keyed by buffer name; no buffer is written.
* **Init recipe** (the reference's, gossip_sgd.py:693-707 there): each
  module carries its initializer as an attribute, read by
  ``models/convert.py::init_model_params``: convolutions kaiming-normal
  fan-out (untruncated), ``fc ~ N(0, 0.01)`` with zero bias, BatchNorm
  scale 1 except the third norm of every Bottleneck (0).
* ``dtype=torch.bfloat16`` computes the convolutions, the head and the
  activations in bf16 while parameters and BatchNorm statistics stay
  fp32 (the reference's flagship benchmark setting).

``small_images`` is the CIFAR stem (3x3/1, no max-pool).

The reference's two MFU experiments are here too, as model arguments
(the reference reaches them from its bench only, ``BENCH_S2D`` and
``BENCH_NORM``; ``--stem_s2d`` is also a flag of its CLI):

* ``stem_s2d`` replaces the 7x7/2 stem by the equivalent 4x4/1
  convolution over the 2x2 space-to-depth input
  (:func:`space_to_depth`, :func:`s2d_stem_kernel`, block-space pads
  ``(2, 1)``).  Its kernel is drawn as the 7x7 one and transformed
  (``kernel_init="s2d_fan_out_normal"``), so the init distribution is
  the 7x7 stem's.  Odd image sizes are refused, as the reference refuses
  them.
* ``norm_variant`` ``"bn16"`` takes the batch statistics in the compute
  dtype (the fast variance ``E[x^2] - E[x]^2``, clamped at 0; the
  running averages stay fp32) and normalises in the compute dtype;
  ``"folded"`` normalises with the running statistics in training too
  and leaves them unchanged, with no batch reduction forward or backward
  (the reference's ``ProbeBatchNorm``: an attribution probe, not a
  training configuration).

Checkpoints do not carry across either argument (the stem's kernel
shape; the norms' flax names, ``ProbeBatchNorm_{i}``), as in the
reference.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["BatchNorm", "Conv2d", "Linear", "BasicBlock", "Bottleneck",
           "ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "RESNETS", "NORM_VARIANTS", "space_to_depth",
           "s2d_stem_kernel"]

BN_MOMENTUM = 0.9
BN_EPS = 1e-5
NORM_VARIANTS = ("bn", "bn16", "folded")


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """NCHW space-to-depth: each ``block x block`` spatial tile packed
    into channels, ``[N, C, H, W] -> [N, b*b*C, H/b, W/b]``, channel
    ``(dy*b + dx)*C + c`` (the reference's ``(dy, dx, c)`` packing order,
    matched by :func:`s2d_stem_kernel`)."""
    n, c, h, w = x.shape
    if h % block or w % block:
        raise ValueError(
            f"stem_s2d requires spatial dims divisible by {block}, got "
            f"{h}x{w} — use the standard stem for odd image sizes")
    x = x.reshape(n, c, h // block, block, w // block, block)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(
        n, block * block * c, h // block, w // block)


def s2d_stem_kernel(k7: torch.Tensor) -> torch.Tensor:
    """The 7x7 stride-2 stem kernel ``[F, C, 7, 7]`` as the equivalent
    4x4 stride-1 kernel ``[F, 4C, 4, 4]`` over :func:`space_to_depth`
    input: zero-padded at the front to 8x8 (``out[i] = Σ_u k8[u]
    x[2i-4+u]``), then each 2x2 tap block folded into channels in the
    ``(dy, dx, c)`` order.  The stem convolution then pads ``(2, 1)`` in
    block space."""
    f, c, kh, kw = k7.shape
    if (kh, kw) != (7, 7):
        raise ValueError("the stem transform is specific to 7x7/2")
    k8 = F.pad(k7, (1, 0, 1, 0))
    # [F, C, ky, dy, kx, dx] -> [F, dy, dx, C, ky, kx]
    k4 = k8.reshape(f, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    return k4.reshape(f, 4 * c, 4, 4)


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA ``SAME`` padding of one spatial dim: ``(low, high)``."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Conv2d):
    """Bias-free convolution with flax's padding: ``padding="same"``
    (``SAME``, asymmetric where XLA's is), explicit symmetric pads, or
    ``(low, high)`` pads on both spatial dims.  ``kernel_init`` is
    ``"fan_out_normal"`` (the ResNet recipe), ``"s2d_fan_out_normal"``
    (the s2d stem: the 7x7 recipe transformed by
    :func:`s2d_stem_kernel`) or ``"lecun_normal"`` (flax's default)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding="same", kernel_init: str = "fan_out_normal"):
        super().__init__(cin, cout, k, stride=stride, padding=0, bias=False)
        self.same = padding == "same"
        self.pad = 0 if self.same else padding if isinstance(
            padding, tuple) else int(padding)
        self.kernel_init = kernel_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.pad
        if isinstance(pad, tuple):
            x, pad = F.pad(x, (*pad, *pad)), 0
        elif self.same:
            (kh, kw), (sh, sw) = self.kernel_size, self.stride
            ph, pw = (_same_pads(x.shape[2], kh, sh),
                      _same_pads(x.shape[3], kw, sw))
            if ph[0] == ph[1] and pw[0] == pw[1]:
                pad = (ph[0], pw[0])
            else:
                x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride, pad)


class Linear(nn.Linear):
    """Dense layer computing in the input's dtype; ``kernel_init`` is
    ``("normal", std)`` or ``"lecun_normal"``, the bias starts at 0."""

    def __init__(self, cin: int, cout: int, kernel_init=("normal", 0.01)):
        super().__init__(cin, cout)
        self.kernel_init = kernel_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel dim of NCHW (see the module
    docstring).  ``train`` normalizes with the batch statistics and, when
    ``stats_out`` is a dict, writes the new running statistics there
    under ``{stats_key}.running_mean`` / ``.running_var``; otherwise it
    normalizes with the running statistics.  The output has the input's
    dtype; the arithmetic is the input's dtype promoted to at least fp32
    (flax's ``_compute_stats`` rule).  A ``variant`` of ``"bn16"`` or
    ``"folded"`` (the model's ``norm_variant``) is the reference's
    ``ProbeBatchNorm`` instead (:meth:`_probe`)."""

    def __init__(self, features: int, scale_init: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.scale_init = float(scale_init)
        # the state-dict prefix and the norm variant, set by the model
        self.stats_key = ""
        self.variant = "bn"

    def forward(self, x: torch.Tensor, train: bool,
                stats_out: dict | None = None) -> torch.Tensor:
        if self.variant != "bn":
            return self._probe(x, train, stats_out)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp(xf.square().mean((0, 2, 3)) - mean.square(),
                              min=0.0)
            if stats_out is not None:
                m = BN_MOMENTUM
                stats_out[self.stats_key + "running_mean"] = (
                    m * self.running_mean + (1 - m) * mean.detach())
                stats_out[self.stats_key + "running_var"] = (
                    m * self.running_var + (1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)

    def _probe(self, x, train, stats_out):
        """The reference's ``ProbeBatchNorm`` (``models/resnet.py:64-136``
        there), in the compute dtype ``x.dtype``.  ``"bn16"`` in training:
        the batch mean and the fast variance ``E[x^2] - E[x]^2`` (clamped
        at 0) in the compute dtype, each mean summed in at least fp32 and
        rounded once (jnp's mean); the running averages advance in fp32.
        ``"folded"``: the running statistics in training too, written
        back unchanged.  Both normalize as ``(x - mean) * (rsqrt(var +
        eps) * scale) + bias``, every operand in the compute dtype."""
        cdt = x.dtype
        if train and self.variant == "bn16":
            acc = torch.promote_types(cdt, torch.float32)
            mean = x.to(acc).mean((0, 2, 3)).to(cdt)
            sq = x.square().to(acc).mean((0, 2, 3)).to(cdt)
            var = torch.clamp(sq - mean.square(), min=0)
            if stats_out is not None:
                m = BN_MOMENTUM
                stats_out[self.stats_key + "running_mean"] = (
                    m * self.running_mean + (1 - m) * mean.detach().float())
                stats_out[self.stats_key + "running_var"] = (
                    m * self.running_var + (1 - m) * var.detach().float())
        else:
            mean, var = self.running_mean, self.running_var
            if train and stats_out is not None:
                stats_out[self.stats_key + "running_mean"] = mean
                stats_out[self.stats_key + "running_var"] = var
        inv = torch.rsqrt(var.to(cdt) + torch.tensor(BN_EPS, dtype=cdt)) \
            * self.weight.to(cdt)
        return (x - mean.to(cdt)[:, None, None]) * inv[:, None, None] \
            + self.bias.to(cdt)[:, None, None]


def _name_norms(model: nn.Module, variant: str = "bn") -> None:
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            mod.stats_key = f"{name}." if name else ""
            mod.variant = variant


class BasicBlock(nn.Module):
    """Two 3x3 convolutions (resnet18/34); the second norm keeps scale 1
    (the reference zero-inits Bottleneck norms only)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, filters, 3, stride)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv2d(filters, filters, 3)
        self.bn2 = BatchNorm(filters)
        self.downsample = _projection(cin, filters, stride)

    def forward(self, x, train: bool, stats_out=None):
        y = F.relu(self.bn1(self.conv1(x), train, stats_out))
        y = self.bn2(self.conv2(y), train, stats_out)
        return F.relu(_shortcut(self, x, train, stats_out) + y)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 with 4x expansion (resnet50/101/152);
    the third norm's scale starts at 0."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, filters, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv2d(filters, filters, 3, stride)
        self.bn2 = BatchNorm(filters)
        self.conv3 = Conv2d(filters, filters * 4, 1)
        self.bn3 = BatchNorm(filters * 4, scale_init=0.0)
        self.downsample = _projection(cin, filters * 4, stride)

    def forward(self, x, train: bool, stats_out=None):
        y = F.relu(self.bn1(self.conv1(x), train, stats_out))
        y = F.relu(self.bn2(self.conv2(y), train, stats_out))
        y = self.bn3(self.conv3(y), train, stats_out)
        return F.relu(_shortcut(self, x, train, stats_out) + y)


def _projection(cin: int, cout: int, stride: int):
    """The 1x1 projection shortcut (flax's ``conv_proj``/``norm_proj``),
    where the block changes the shape."""
    if cin == cout and stride == 1:
        return None
    return nn.Sequential(Conv2d(cin, cout, 1, stride), BatchNorm(cout))


def _shortcut(block, x, train, stats_out):
    if block.downsample is None:
        return x
    conv, norm = block.downsample
    return norm(conv(x), train, stats_out)


class ResNet(nn.Module):
    """ImageNet-style ResNet over NCHW batches.

    ``forward(x, train=True, stats_out=None)`` returns fp32 logits; see
    :class:`BatchNorm` for ``train`` and ``stats_out``."""

    def __init__(self, stage_sizes, block_cls, num_classes: int = 1000,
                 num_filters: int = 64, dtype=torch.float32,
                 small_images: bool = False, stem_s2d: bool = False,
                 norm_variant: str = "bn"):
        super().__init__()
        if norm_variant not in NORM_VARIANTS:
            raise ValueError(f"unknown norm_variant {norm_variant!r}")
        self.dtype = dtype
        self.small_images = bool(small_images)
        # the CIFAR stem wins over stem_s2d, as in the reference
        self.stem_s2d = bool(stem_s2d) and not small_images
        self.norm_variant = norm_variant
        if small_images:
            self.conv1 = Conv2d(3, num_filters, 3)
        elif self.stem_s2d:
            self.conv1 = Conv2d(12, num_filters, 4, 1, padding=(2, 1),
                                kernel_init="s2d_fan_out_normal")
        else:
            self.conv1 = Conv2d(3, num_filters, 7, 2, padding=3)
        self.bn1 = BatchNorm(num_filters)
        cin = num_filters
        self.stages = len(stage_sizes)
        for i, count in enumerate(stage_sizes):
            blocks = []
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(cin, num_filters * 2 ** i, stride))
                cin = num_filters * 2 ** i * block_cls.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc = Linear(cin, num_classes)
        _name_norms(self, norm_variant)

    def forward(self, x: torch.Tensor, train: bool = True,
                stats_out: dict | None = None) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.stem_s2d:
            x = space_to_depth(x, 2)
        x = F.relu(self.bn1(self.conv1(x), train, stats_out))
        if not self.small_images:
            x = F.max_pool2d(x, 3, 2, padding=1)
        for i in range(self.stages):
            for block in getattr(self, f"layer{i + 1}"):
                x = block(x, train, stats_out)
        x = x.mean((2, 3), dtype=torch.promote_types(
            x.dtype, torch.float32)).to(self.dtype)
        return self.fc(x).float()


resnet18 = functools.partial(ResNet, [2, 2, 2, 2], BasicBlock)
resnet34 = functools.partial(ResNet, [3, 4, 6, 3], BasicBlock)
resnet50 = functools.partial(ResNet, [3, 4, 6, 3], Bottleneck)
resnet101 = functools.partial(ResNet, [3, 4, 23, 3], Bottleneck)
resnet152 = functools.partial(ResNet, [3, 8, 36, 3], Bottleneck)

RESNETS = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
}
