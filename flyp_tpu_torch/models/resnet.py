"""ModifiedResNet image tower (the RN50 family).

Counterpart of ``flyp_tpu/models/resnet.py``: the 3-conv stem with an
average pool, anti-aliased strided bottlenecks (an average pool before the
strided 1x1 conv, on the main branch and on the shortcut), and a QKV
attention pool in place of global average pooling.

Images arrive ``[B, H, W, 3]`` as the ViT takes them; ``permute(0, 3, 1, 2)``
is a free channels-last NCHW view, and every activation stays channels-last,
so cuDNN runs its NHWC convolutions without a layout transpose.  Conv
kernels are held HWIO (``kernel [kh, kw, in, out]``) as the JAX tree holds
them, and made channels-last OIHW in the compute type where they are used.

BatchNorm follows torch's train-mode semantics (:class:`TorchBatchNorm`);
its running statistics are the module's buffers (``mean``/``var``), named
as the JAX ``batch_stats`` tree names them.  On a mesh whose batch axes
split the batch over ranks, the train step gives every BatchNorm the batch
axes' process group (:func:`synced_batch_norm`): its statistics are then the
global batch's, as the JAX layer's ``jnp.mean``/``jnp.var`` over the batch
axis are under GSPMD.  The ``s2d`` stem of the JAX
package is a TPU layout of the same numbers
(``flyp_tpu/models/configs.py::VisionConfig.stem_impl``): here both values
run the reference stem.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from flyp_tpu_torch.models.configs import VisionConfig
from flyp_tpu_torch.ops.attention import multi_head_attention
from flyp_tpu_torch.parallel.comm import all_reduce_, group_size


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at 2 sigma, scaled to a
    variance of ``1 / fan_in``."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


_CHANNELS = (0, 2, 3)  # the axes a channel's statistics run over, NCHW


def _per_channel(t: torch.Tensor) -> torch.Tensor:
    return t.view(1, -1, 1, 1)


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the rows of every rank of ``group``, in
    fp32, as ``flyp_tpu/models/resnet.py::TorchBatchNorm`` computes it on
    the global batch.

    Statistics are float32 (float64 for a float64 input, which the tests
    use).  Forward, two passes with one all-reduce each: ``[sum x]`` gives the
    mean, then ``[sum (x - mean)^2]`` the biased variance (a single pass of
    ``[sum x, sum x^2]`` would cancel); ``n`` is the rows of one rank times
    the group's size (the mesh splits the batch evenly).  The running
    statistics move with the global ``n``, in the JAX layer's order of
    operations, so every rank writes the same bits.  Backward, one
    all-reduce of ``[sum dy, sum dy xhat]``: the transpose of the forward's
    sums of different rows is their sum over the group, so
    ``dx = scale rstd (dy - mean(dy) - xhat mean(dy xhat))`` with both means
    global.  ``dscale`` and ``dbias`` are this rank's own sums: the train
    step sums every gradient over the batch axes once."""

    @staticmethod
    def forward(ctx, x, scale, bias, running_mean, running_var, momentum, epsilon, update, group):
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        n = x.numel() // x.shape[1] * group_size(group)
        mean = all_reduce_(x32.sum(_CHANNELS), group) / n
        centered = x32 - _per_channel(mean)
        var = all_reduce_(centered.square().sum(_CHANNELS), group) / n
        if update:
            m = momentum
            running_mean.copy_(m * running_mean + (1 - m) * mean)
            running_var.copy_(m * running_var + (1 - m) * var * (n / max(n - 1, 1)))
        rstd = torch.rsqrt(var + epsilon)
        xhat = centered * _per_channel(rstd)
        ctx.save_for_backward(x, mean, rstd, scale)
        ctx.n, ctx.group = n, group
        return (xhat * _per_channel(scale) + _per_channel(bias)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd, scale = ctx.saved_tensors
        xhat = (x.to(mean.dtype) - _per_channel(mean)) * _per_channel(rstd)
        dy = g.to(mean.dtype)
        local = torch.stack([dy.sum(_CHANNELS), (dy * xhat).sum(_CHANNELS)])
        total = all_reduce_(local.clone(), ctx.group) / ctx.n
        dx = _per_channel(scale * rstd) * (dy - _per_channel(total[0]) - xhat * _per_channel(total[1]))
        return dx.to(x.dtype), local[1], local[0], None, None, None, None, None, None


class TorchBatchNorm(nn.Module):
    """BatchNorm over the channels of an NCHW tensor, torch-exact in train mode.

    In training mode it normalises with the batch's biased variance and, if
    ``update_stats`` holds, moves the running ``var`` towards the unbiased
    one (``n/(n-1)``); in eval mode it normalises with the running
    statistics.  Statistics are float32 whatever the activation type, and
    the output is cast to the activation type.  ``momentum`` follows the
    flax convention (flax 0.9 is torch's 0.1).  With a ``group`` (set by
    :func:`synced_batch_norm`) training mode runs :class:`_SyncBatchNorm`:
    the statistics of the rows of every rank of the group."""

    group = None

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.update_stats = True
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias, training=False, eps=self.epsilon)
        write = self.update_stats
        if self.group is not None:
            return _SyncBatchNorm.apply(x, self.scale, self.bias, self.mean, self.var, self.momentum, self.epsilon,
                                        write, self.group)
        if x.numel() == x.shape[1]:
            return self._one_value_per_channel(x, write)
        return F.batch_norm(x, self.mean if write else None, self.var if write else None, self.scale, self.bias,
                            training=True, momentum=1 - self.momentum, eps=self.epsilon)

    def _one_value_per_channel(self, x: torch.Tensor, write: bool) -> torch.Tensor:
        """Train mode on one value a channel (a per-example pass that reaches a
        1x1 map), where ``F.batch_norm`` raises: the JAX layer's formula, so
        the mean is ``x``, the variance 0, the output ``bias`` and ``dx``
        zero; the running variance moves with the factor ``n / max(n - 1,
        1)`` = 1."""
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = x32.mean(_CHANNELS)
        var = (x32 - _per_channel(mean)).square().mean(_CHANNELS)
        if write:
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        y = (x32 - _per_channel(mean)) * _per_channel(torch.rsqrt(var + self.epsilon))
        return (y * _per_channel(self.scale) + _per_channel(self.bias)).to(x.dtype)


@contextlib.contextmanager
def running_stats_frozen(model: nn.Module):
    """Train-mode BatchNorm in the body normalises with batch statistics
    but leaves the running statistics as they are."""
    norms = [m for m in model.modules() if isinstance(m, TorchBatchNorm)]
    for m in norms:
        m.update_stats = False
    try:
        yield model
    finally:
        for m in norms:
            m.update_stats = True


@contextlib.contextmanager
def synced_batch_norm(model: nn.Module, group):
    """Train-mode BatchNorm in the body normalises with the statistics of
    the rows of every rank of ``group`` (the mesh's batch axes); None, an
    axis of one rank, changes nothing."""
    norms = [m for m in model.modules() if isinstance(m, TorchBatchNorm)] if group is not None else []
    for m in norms:
        m.group = group
    try:
        yield model
    finally:
        for m in norms:
            m.group = None


class Conv2d(nn.Module):
    """A convolution without bias; ``padding`` pixels of zeros on each side."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.kernel = nn.Parameter(torch.empty(kernel, kernel, cin, cout))

    def reset_parameters(self, generator: torch.Generator) -> None:
        kh, kw, cin, _ = self.kernel.shape
        _lecun_normal_(self.kernel, kh * kw * cin, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.permute(3, 2, 0, 1).to(x.dtype, memory_format=torch.channels_last)
        return F.conv2d(x, w, stride=self.stride, padding=self.padding)


class Dense(nn.Module):
    """flax ``nn.Dense`` in the activation type: ``x @ kernel + bias``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.kernel.to(x.dtype)) + self.bias.to(x.dtype)


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, expansion: int = 4):
        super().__init__()
        out_planes = planes * expansion
        self.stride = stride
        self.conv1, self.bn1 = Conv2d(inplanes, planes, 1), TorchBatchNorm(planes)
        self.conv2, self.bn2 = Conv2d(planes, planes, 3, padding=1), TorchBatchNorm(planes)
        self.conv3, self.bn3 = Conv2d(planes, out_planes, 1), TorchBatchNorm(out_planes)
        self.downsample = stride > 1 or inplanes != out_planes
        if self.downsample:
            self.downsample_conv = Conv2d(inplanes, out_planes, 1)
            self.downsample_bn = TorchBatchNorm(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.downsample_bn(self.downsample_conv(identity))
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """QKV attention of the mean token over itself and the HW positions.

    Attention rows are independent, so q is projected for the mean token
    alone (the reference attends from every token and keeps the first
    row): the same output and gradients, as in the JAX package."""

    def __init__(self, grid: int, width: int, embed_dim: int, heads: int, output_dim: int):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, width))
        self.q_proj, self.k_proj = Dense(width, embed_dim), Dense(width, embed_dim)
        self.v_proj, self.c_proj = Dense(width, embed_dim), Dense(embed_dim, output_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.positional_embedding.normal_(0.0, self.positional_embedding.shape[1] ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: ``[B, C, H, W]`` -> ``[B, output_dim]``."""
        B, C, H, W = x.shape
        x = x.permute(0, 2, 3, 1).reshape(B, H * W, C)
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1) + self.positional_embedding.to(x.dtype)
        hd = self.q_proj.kernel.shape[1] // self.heads
        q = self.q_proj(x[:, :1]).reshape(B, 1, self.heads, hd)
        k = self.k_proj(x).reshape(B, H * W + 1, self.heads, hd)
        v = self.v_proj(x).reshape(B, H * W + 1, self.heads, hd)
        o = multi_head_attention(q, k, v, causal=False)
        return self.c_proj(o.reshape(B, self.heads * hd))


class ModifiedResNet(nn.Module):
    def __init__(self, config: VisionConfig, embed_dim: int):
        super().__init__()
        self.config = config
        width = config.width
        self.conv1, self.bn1 = Conv2d(3, width // 2, 3, stride=2, padding=1), TorchBatchNorm(width // 2)
        self.conv2, self.bn2 = Conv2d(width // 2, width // 2, 3, padding=1), TorchBatchNorm(width // 2)
        self.conv3, self.bn3 = Conv2d(width // 2, width, 3, padding=1), TorchBatchNorm(width)
        self.blocks = []
        inplanes = width
        for stage, (blocks, planes, stride) in enumerate(
                zip(config.resnet_layers, (width, width * 2, width * 4, width * 8), (1, 2, 2, 2))):
            for b in range(blocks):
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, Bottleneck(inplanes, planes, stride if b == 0 else 1))
                self.blocks.append(name)
                inplanes = planes * 4
        self.attnpool = AttentionPool2d(config.image_size // 32, width * 32, width * 32, config.heads, embed_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: ``[B, H, W, 3]`` (NHWC) in the compute type -> ``[B, embed_dim]``."""
        x = images.permute(0, 3, 1, 2)  # a channels-last NCHW view
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.avg_pool2d(x, 2)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.attnpool(x)
