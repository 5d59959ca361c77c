"""Cross-field (frame-field) algebra on complex64 tensors — port of
pixelspointspolygons_tpu/ops/crossfield.py.

The frame field at each pixel is the root set of f(z) = z^4 + c2 z^2 + c0,
which encodes two direction pairs {±u, ±v}. The network emits 4 real
channels (Re c0, Im c0, Re c2, Im c2).

On the CPU, torch's complex64 products give XLA's bits here
(`tests/test_torch_ffl.py` holds each function to JAX's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def crossfield_to_c0c2(crossfield: torch.Tensor, channel_axis: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a 4-real-channel crossfield (channels [Re c0, Im c0, Re c2,
    Im c2] on `channel_axis`) into complex (c0, c2)."""
    c0r, c0i, c2r, c2i = crossfield.unbind(channel_axis)
    return torch.complex(c0r, c0i), torch.complex(c2r, c2i)


def uv_to_c0c2(u: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """c0 = u^2 v^2, c2 = -(u^2 + v^2), so that f(z) = (z^2 - u^2)(z^2 - v^2)."""
    u2, v2 = u * u, v * v
    return u2 * v2, -(u2 + v2)


def framefield_align_error(c0: torch.Tensor, c2: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """|z^4 + c2 z^2 + c0|^2: zero iff the unit direction z lies on the field."""
    z2 = z * z
    f = z2 * z2 + c2 * z2 + c0
    return f.real ** 2 + f.imag ** 2


def c0c2_to_uv(c0: torch.Tensor, c2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two direction pairs: u, v with u^2, v^2 the roots of
    w^2 + c2 w + c0. Complex tensors of c0's shape."""
    disc = torch.sqrt(c2 * c2 - 4.0 * c0)
    u2 = -(c2 + disc) / 2.0
    v2 = -(c2 - disc) / 2.0
    return torch.sqrt(u2), torch.sqrt(v2)


def closest_in_uv(directions: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """0 where a direction is closer to {±u}, 1 where closer to {±v}: the
    smaller |dot| with the other axis decides (int32)."""
    dot_u = (u.real * directions.real + u.imag * directions.imag).abs()
    dot_v = (v.real * directions.real + v.imag * directions.imag).abs()
    return (dot_v < dot_u).to(torch.int32)


_LAPLACIAN = [[0.5, 1.0, 0.5], [1.0, -6.0, 1.0], [0.5, 1.0, 0.5]]


def laplacian_penalty(x: torch.Tensor) -> torch.Tensor:
    """|Laplacian(x)| per channel of a real (B, C, H, W) map, zero-padded."""
    c = x.shape[1]
    k = torch.tensor(_LAPLACIAN, dtype=torch.float32, device=x.device) / 12.0
    k = k.to(x.dtype)[None, None].expand(c, 1, 3, 3)
    return F.conv2d(x, k, padding=1, groups=c).abs()


def angle_to_z(angle: torch.Tensor) -> torch.Tensor:
    """Unit complex from an angle in radians."""
    return torch.complex(torch.cos(angle), torch.sin(angle))
