"""Layers with flax.linen's semantics, so bridged weights train the same way
— port of pixelspointspolygons_tpu/models/layers.py plus flax's defaults.

- `BatchNorm`: flax `nn.BatchNorm(momentum=0.9)` over the channel axis 1
  (NCHW maps, or (N, C) rows). Flax updates the running variance with the
  *biased* batch variance; `torch.nn.BatchNorm2d` uses the unbiased one, so
  it cannot stand in. Torch momentum 0.1 is flax momentum 0.9. Inside
  `running_stats_frozen(module)` a train-mode forward leaves the running
  statistics as they are (a recomputed forward, `train/hisup_step.py`).
  Whenever a process group is initialised (`parallel.is_distributed`, also
  at world size 1) a train-mode forward normalizes by the statistics of the
  global batch, as JAX's BatchNorm under a mesh-sharded `jit` does
  (`_SyncBatchNormFn`); without one the path is the local one.
- `LayerNorm`: flax's eps is 1e-6 (torch's default 1e-5).
- `MultiHeadAttention`: explicit q/k/v/o projections, logits divided by
  √Dh after the product, softmax in float32, masks as an additive −1e9
  (`causal_bias`, `padding_bias`); `project_kv` and `attend` let the
  KV-cached decode reuse the weights.
- `resize_bilinear`: `jax.image.resize(..., "bilinear")` of an NCHW map
  (HiSup's decoder input, `ViTCNNEncoder`'s token map, FFL's HRNet map);
  its backward is always products with the interpolation matrices, as
  JAX's gradient is (`InterpolateByProducts` where the forward is
  `F.interpolate`), so it adds in one order on the card.
- `init_flax_defaults`: flax's default initializers — conv and dense
  kernels and embeddings `lecun_normal` (truncated normal on [-2σ, 2σ],
  fan_in), zero biases, BatchNorm and LayerNorm scale 1 and bias 0 —
  instead of torch's kaiming-uniform; modules with raw parameters draw them
  in their own `reset_flax_parameters(generator)`.

Compute dtype (flax's `dtype=`, e.g. bfloat16). The parameters stay float32
and each layer computes in its `dtype`: `Dense`, `Embed`, `Conv2d` and
`Conv1d` cast input and parameters to it and give it; `LayerNorm` and
`BatchNorm` compute their statistics and affine transform in float32 and
give `dtype`; attention
logits are the product in `dtype` divided by √Dh rounded to `dtype`, the
softmax computes in float32 and rounds its output to `dtype`. `dtype=None` computes in the parameters' own
dtype (float32, or float64 after `.double()`). Inside `cast_once(module)`
the layers use parameters cast once on entry, so the 385 steps of the
KV-cached decode cast none per step.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import parallel


def cast_to(t: torch.Tensor | None, dtype: torch.dtype | None) -> torch.Tensor | None:
    """`t` in `dtype`, with no call where it is already (or `dtype` is None)."""
    return t if t is None or dtype is None or t.dtype == dtype else t.to(dtype)


def layout_of(x: torch.Tensor) -> torch.memory_format:
    """channels_last for a 4-D tensor stored so (the convolutions of an
    NHWC input keep it), else the contiguous format."""
    return torch.channels_last if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last) \
        else torch.contiguous_format


def widen(dtype: torch.dtype) -> torch.dtype:
    """The dtype flax computes statistics, softmaxes and losses in: float32,
    or float64 for float64 (in Python: `torch.promote_types` is an aten call,
    which a decode step would pay at every norm and softmax)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def cached_matrix(build):
    """`build` (a function of sizes, dtype and device) evaluated once per
    arguments and kept: the interpolation matrices are constants, and each
    takes a dozen small operations to build, which a train step would pay
    at every one of HRNet's resizes. Built outside inference mode, so that
    a matrix a predictor built first can be saved for a backward later."""
    @functools.lru_cache(maxsize=None)
    def cached(*args):
        with torch.inference_mode(False), torch.no_grad():
            return build(*args)

    return functools.wraps(build)(cached)


@cached_matrix
def _resize_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_in, n_out) weights of `jax.image.resize(..., "bilinear")` along one
    axis (jax/_src/image/scale.py::compute_weight_mat, antialiased, in
    float32): half-pixel centres, a triangle kernel widened by the scale
    when it shrinks, each column normalized."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs() / kernel_scale
    w = (1.0 - x).clamp(min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


class InterpolateByProducts(torch.autograd.Function):
    """`F.interpolate`'s bilinear forward, kept for its bits, with the
    backward as the products with the interpolation matrices that JAX's
    gradient of its resize is: W contracted first, then H, in x's dtype, in
    x's memory layout. On the card `upsample_bilinear2d`'s own backward adds
    with atomics, in another order each run. `rows` (H2, H) and `cols`
    (W2, W) are the matrices for which the forward is rows @ x @ cols.T."""

    @staticmethod
    def forward(ctx, x, rows, cols, align_corners: bool):
        ctx.save_for_backward(rows, cols)
        ctx.layout = layout_of(x)
        return F.interpolate(x, size=(rows.shape[0], cols.shape[0]), mode="bilinear", align_corners=align_corners)

    @staticmethod
    def backward(ctx, g):
        rows, cols = ctx.saved_tensors
        gx = torch.matmul(rows.T, torch.matmul(g, cols))
        return gx.contiguous(memory_format=ctx.layout), None, None, None


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """`jax.image.resize(x, ..., "bilinear")` of an NCHW map to size x size.
    Enlarging at float32 or float64 it is `F.interpolate` (half-pixel
    centres; jax applies no antialiasing when it enlarges), whose gradient
    is JAX's: the transposed products with the weight matrices
    (`InterpolateByProducts`). Otherwise it is JAX's arithmetic: the weight
    matrices cast to x's dtype, H contracted first, then W, each product
    rounded to x's dtype; the result in x's memory layout, as
    `F.interpolate` gives it; autograd's gradient of those products."""
    H, W = x.shape[2:]
    if (H, W) == (size, size):
        return x
    if x.dtype in (torch.float32, torch.float64) and H <= size and W <= size:
        return InterpolateByProducts.apply(x, _resize_matrix(H, size, x.device).to(x.dtype).T,
                                           _resize_matrix(W, size, x.device).to(x.dtype).T, False)
    y = torch.matmul(_resize_matrix(H, size, x.device).to(x.dtype).T, x)
    y = torch.matmul(y, _resize_matrix(W, size, x.device).to(x.dtype))
    return y.contiguous(memory_format=layout_of(x))


def _synchronised() -> bool:
    """Whether train-mode BatchNorms take global batch statistics."""
    return parallel.is_distributed()


class _SyncBatchNormFn(torch.autograd.Function):
    """Train-mode batch normalization over every axis but 1 (NCHW maps or
    (N, C) rows) with the statistics of the batch over all processes, in
    few calls: its cost on the host is what the DDP step pays for it.

    Forward: each process takes its count, mean and biased variance
    (`torch.var_mean`, never E[x²] − E[x]²); one all-gather of the three
    per-channel rows, combined by Chan's formula in float64, gives every
    process the same global statistics, by which `F.batch_norm` normalizes.

    Backward: torch's batch-norm backward from the global statistics takes
    its means over the local rows. Its local sums Σg and Σg·x̂ (the bias and
    weight gradients) are summed over processes in one all-reduce, and the
    input gradient is moved from the local means to the global ones
    (nothing moves in one process). The weight and bias gradients stay the
    local sums, which DDP averages as it averages every other gradient.
    Returns (output, mean, var)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        var, mean = torch.var_mean(x, [d for d in range(x.dim()) if d != 1], correction=0)
        n = x.numel() // x.shape[1]
        rows = torch.stack([torch.full_like(mean, n), mean, var]).double()
        counts, means, variances = parallel.all_gather_stacked(rows, "batch_norm").unbind(1)
        total = counts.sum(0)
        share = counts / total
        mean64 = (share * means).sum(0)
        mean, var = mean64.to(x.dtype), (share * (variances + (means - mean64).square())).sum(0).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps))
        ctx.eps, ctx.n, ctx.total = eps, n, total.to(x.dtype)
        ctx.mark_non_differentiable(mean, var)
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps), mean, var

    @staticmethod
    def backward(ctx, g, _gm, _gv):
        x, weight, mean, invstd = ctx.saved_tensors
        shape = (1, -1) + (1,) * (x.dim() - 2)
        grad, grad_weight, grad_bias = torch.ops.aten.native_batch_norm_backward(
            g, x, weight, None, None, mean, invstd, True, ctx.eps, [True, True, True])
        local = torch.stack([grad_bias, grad_weight])
        shift, tilt = (local / ctx.n - parallel.all_reduce_sum(local.clone(), "batch_norm") / ctx.total) * (
            weight * invstd)
        grad.addcmul_(x - mean.view(shape), (tilt * invstd).view(shape)).add_(shift.view(shape))
        return grad, grad_weight, grad_bias, None


class BatchNorm(nn.Module):
    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5, dtype=None, device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))
        self.update_running_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is not None:
            x = cast_to(x, widen(dt))
        if not self.training:
            return cast_to(F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps
            ), dt)
        if _synchronised():
            out, mean, var = _SyncBatchNormFn.apply(x, self.weight, self.bias, self.eps)
            if self.update_running_stats:
                self._update_running_stats(mean, var)
            return cast_to(out, dt)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if not self.update_running_stats:
            return cast_to(out, dt)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=[d for d in range(x.ndim) if d != 1], unbiased=False)
        self._update_running_stats(mean, var)
        return cast_to(out, dt)

    @torch.no_grad()
    def _update_running_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
        self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)


class _RowBatchNormFn(torch.autograd.Function):
    """Train-mode batch normalization of a (N, C) matrix over its rows,
    from statistics that `torch.var_mean` gives (see `RowBatchNorm`).
    Returns (output, mean, var); the backward is BatchNorm's, with its two
    per-channel sums taken by `Tensor.sum`."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        var, mean = torch.var_mean(x, dim=0, unbiased=False)
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.mark_non_differentiable(mean, var)
        # flax's order: (x - mean) · (rsqrt(var + eps) · scale) + bias
        return torch.addcmul(bias, x - mean, invstd * weight), mean, var

    @staticmethod
    def backward(ctx, g, _gm, _gv):
        x, weight, mean, invstd = ctx.saved_tensors
        n = x.shape[0]
        xhat = (x - mean).mul_(invstd)
        sum_g, sum_gx = g.sum(dim=0), (g * xhat).sum(dim=0)
        grad = (g - sum_g / n).sub_(xhat.mul_(sum_gx / n)).mul_(invstd * weight)
        return grad, sum_gx, sum_g, None


class RowBatchNorm(BatchNorm):
    """`BatchNorm` of (N, C) rows whose train-mode statistics come from
    `torch.var_mean` (the PillarFeatureNet's, over B·N = 3.2M points at
    full size). Torch's own batch-norm kernel on the CPU sums each channel
    of a (N, C) input in one running float32 sum: at 4·10^5 rows its output
    is off by 1e-3, where `var_mean` and `Tensor.sum` (cascade sums on the
    CPU, tree reductions on the card) stay within 1e-6. The same memory as
    `F.batch_norm`: the backward keeps only the input. Under a process
    group it is `BatchNorm`'s synchronised path: its statistics are
    `var_mean`'s, its backward's sums torch's batch-norm kernel's, which
    at 4·10^5 rows on the CPU read 3e-5 from float64 in the weight
    gradient (`Tensor.sum`: 1.2e-6) and 1e-6 in the input gradient."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or _synchronised():
            return super().forward(x)
        dt = self.compute_dtype
        if dt is not None:
            x = cast_to(x, widen(dt))
        out, mean, var = _RowBatchNormFn.apply(x, self.weight, self.bias, self.eps)
        if self.update_running_stats:
            self._update_running_stats(mean, var)
        return cast_to(out, dt)


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module):
    """Within the block, the train-mode BatchNorms of `module` normalize by
    their batch statistics and leave their running statistics unchanged."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.update_running_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_running_stats = True


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None = None) -> None:
    fan_in = weight.shape[1] * math.prod(weight.shape[2:])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # std of N(0,1) cut at ±2
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_flax_defaults(module: nn.Module, generator: torch.Generator | None = None) -> None:
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            # flax Embed: variance_scaling(1, fan_in, normal) over (V, D), fan_in D
            lecun_normal_(m.weight, generator)
        elif isinstance(m, (BatchNorm, nn.LayerNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        if hasattr(m, "reset_flax_parameters"):
            m.reset_flax_parameters(generator)


class _CastConv:
    """flax `nn.Conv(dtype=dtype)`: input, kernel and bias cast to `dtype`,
    the output in it (`dtype` is the compute dtype; the parameters stay as
    they are, and at None or their own dtype no cast is issued)."""

    def __init__(self, *args, dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(cast_to(x, dt), cast_to(self.weight, dt), cast_to(self.bias, dt))


class Conv2d(_CastConv, nn.Conv2d):
    pass


class Conv1d(_CastConv, nn.Conv1d):
    pass


def same_pads(sizes, kernel, stride) -> list[int]:
    """`F.pad`'s list (last axis first) for flax's and lax's "SAME" padding
    of an NCHW map (`lax.padtype_to_pads`): ceil(n / s) outputs, total =
    max((out - 1)·s + k - n, 0), the odd pixel after. At stride 2 on an
    even size that is (0, 1), which torch's symmetric `padding=` cannot
    give: it samples another grid."""
    pads = []
    for n, k, s in reversed(list(zip(sizes, kernel, stride))):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


class SameConv2d(Conv2d):
    """flax `nn.Conv(padding="SAME")` at any stride and size (`same_pads`);
    symmetric pads go to the convolution itself, others to `F.pad` first."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wl, wh, hl, hh = same_pads(x.shape[2:], self.kernel_size, self.stride)
        dt = self.compute_dtype
        x, w, b = cast_to(x, dt), cast_to(self.weight, dt), cast_to(self.bias, dt)
        if (wl, hl) == (wh, hh):
            return F.conv2d(x, w, b, self.stride, (hl, wl), self.dilation, self.groups)
        return F.conv2d(F.pad(x, [wl, wh, hl, hh]), w, b, self.stride, 0, self.dilation, self.groups)


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """`nn.max_pool(x, (k, k), (stride, stride), padding="SAME")` of an NCHW
    map: padded with -inf by `same_pads`."""
    return F.max_pool2d(F.pad(x, same_pads(x.shape[2:], (k, k), (stride, stride)), value=float("-inf")), k, stride)


class Dense(nn.Linear):
    """flax `nn.Dense(dtype=dtype)`: input, kernel and bias cast to `dtype`,
    the output in it. (`dtype` is the compute dtype, not `nn.Linear`'s
    parameter dtype: the parameters stay as they are.)"""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype=None, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype
        self.cached = None  # set by cast_once

    def cast_params(self) -> tuple:
        return cast_to(self.weight, self.compute_dtype), cast_to(self.bias, self.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.cached or self.cast_params()
        return F.linear(cast_to(x, self.compute_dtype), w, b)


class Embed(nn.Embedding):
    """flax `nn.Embed(dtype=dtype)`: the table cast to `dtype`, then looked up."""

    def __init__(self, num_embeddings: int, dim: int, dtype=None, device=None):
        super().__init__(num_embeddings, dim, device=device)
        self.compute_dtype = dtype
        self.cached = None  # set by cast_once

    def cast_params(self) -> tuple:
        return (cast_to(self.weight, self.compute_dtype),)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        (w,) = self.cached or self.cast_params()
        return F.embedding(idx, w)


class LayerNorm(nn.LayerNorm):
    """flax `nn.LayerNorm(dtype=dtype)`: eps 1e-6, scale and bias; mean,
    variance and the affine transform in float32, the output in `dtype`.
    With a compute dtype both casts are issued even where they change
    nothing (at float32), so that a decode step issues the same calls at
    every compute dtype."""

    def __init__(self, dim: int, dtype=None, device=None):
        super().__init__(dim, eps=1e-6, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.layer_norm(x.to(widen(dt)), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(dt)


@contextlib.contextmanager
def cast_once(module: nn.Module):
    """Within the block, the layers of `module` that cast parameters to a
    compute dtype (those with `cast_params`) use copies cast on entry."""
    layers = [m for m in module.modules() if hasattr(m, "cast_params")]
    for m in layers:
        m.cached = m.cast_params()
    try:
        yield
    finally:
        for m in layers:
            m.cached = None


def adaptive_avg_pool1d(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """torch.nn.AdaptiveAvgPool1d over the last axis: window i averages
    [floor(i·in/out), ceil((i+1)·in/out)) (the reference's channel
    bottleneck 384 → 256 on (B, L, C)). As in the JAX package, a product
    with the (in, out) averaging matrix in x's dtype."""
    in_size = x.shape[-1]
    if in_size == out_size:
        return x
    i = torch.arange(out_size, device=x.device)
    starts = (i * in_size) // out_size
    ends = -((-(i + 1) * in_size) // out_size)
    idx = torch.arange(in_size, device=x.device)[:, None]
    mask = (idx >= starts) & (idx < ends)
    return x @ (mask.to(x.dtype) / (ends - starts).to(x.dtype))


def encode_modalities(encoder: nn.Module, batch: dict, **kw) -> torch.Tensor:
    """The encoder's output for a batch by its modality, as the JAX models
    dispatch (e.g. hisup/model.py:166-171): images and LiDAR (early
    fusion), LiDAR points with their mask, or images. `kw` goes to a
    fusion encoder (the LiDAR dropout's generator)."""
    if "lidar" in batch and "images" in batch:
        return encoder(batch["images"], batch["lidar"], batch["lidar_mask"], **kw)
    if "lidar" in batch:
        return encoder(batch["lidar"], batch["lidar_mask"])
    return encoder(batch["images"])


class MlpBlock(nn.Module):
    """Dense → exact (erf) GELU or ReLU → Dense. Flax Dense_0/Dense_1 are
    dense0/dense1."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, activation: str = "gelu", dtype=None,
                 device=None):
        super().__init__()
        self.dense0 = Dense(in_dim, hidden_dim, dtype=dtype, device=device)
        self.dense1 = Dense(hidden_dim, out_dim, dtype=dtype, device=device)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dense0(x)
        h = F.gelu(h) if self.activation == "gelu" else F.relu(h)
        return self.dense1(h)


class MultiHeadAttention(nn.Module):
    """Explicit q/k/v/o projections; takes external K/V and an additive bias."""

    def __init__(self, dim: int, num_heads: int, dtype=None, device=None):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        # flax divides by jnp.sqrt(Dh) cast to the compute dtype
        root = math.sqrt(dim // num_heads)
        self.scale = root if dtype is None else float(torch.tensor(root, dtype=dtype))
        self.q = Dense(dim, dim, dtype=dtype, device=device)
        self.k = Dense(dim, dim, dtype=dtype, device=device)
        self.v = Dense(dim, dim, dtype=dtype, device=device)
        self.o = Dense(dim, dim, dtype=dtype, device=device)

    def project_kv(self, kv_src: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """K/V of a source (e.g. the cross-attention memory), once."""
        return self.k(kv_src), self.v(kv_src)

    def attend(self, q_src: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: torch.Tensor | None = None) -> torch.Tensor:
        """q_src: (B, Lq, D); k, v: (B, Lk, D); bias broadcastable to
        (B, H, Lq, Lk), added to the logits."""
        B, Lq, _ = q_src.shape
        H = self.num_heads
        Dh = self.dim // H
        q = self.q(q_src).reshape(B, Lq, H, Dh).transpose(1, 2)
        kt = k.reshape(B, -1, H, Dh).permute(0, 2, 3, 1)  # (B, H, Dh, Lk)
        vh = v.reshape(B, -1, H, Dh).transpose(1, 2)
        logits = torch.matmul(q, kt) / self.scale
        if bias is not None:
            logits = logits + bias
        # float32 inside for a bfloat16 input, its output rounded once:
        # flax's softmax of the logits cast to float32, cast back
        w = torch.softmax(logits, dim=-1)
        out = torch.matmul(w, vh).transpose(1, 2).reshape(B, Lq, self.dim)
        return self.o(out)

    def forward(self, q_src, kv_src, bias=None):
        k, v = self.project_kv(kv_src)
        return self.attend(q_src, k, v, bias)


def causal_bias(length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(1, 1, L, L) additive causal mask: 0 on and below the diagonal, −1e9 above."""
    future = torch.ones(length, length, dtype=torch.bool, device=device).triu(1)
    return torch.zeros(length, length, dtype=dtype, device=device).masked_fill_(future, -1e9)[None, None]


def padding_bias(pad_mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """pad_mask: (B, Lk) True where PAD → (B, 1, 1, Lk) additive bias."""
    return torch.zeros(pad_mask.shape, dtype=dtype, device=pad_mask.device).masked_fill(pad_mask, -1e9)[:, None, None, :]
