"""Attraction-field map (AFM): per-pixel signed-log offset to the nearest
GT line segment, plus the nearest segment's label.

Port of pixelspointspolygons_tpu/ops/afm.py. Three functions:

- `afm`: the plain PyTorch version, the same row-blocked broadcast plus
  `argmin` as the JAX package's XLA `afm`. It is the oracle for the kernel.
- `afm_cuda`: the wrapper of the hand-written Hopper kernel `csrc/afm.cu`,
  which replaces the Pallas TPU kernel `ops/afm_pallas.py::afm_pallas`. It
  counts its launches in `afm_cuda.launches`.
- `afm_auto`: what HiSup's `encode_targets` calls. CPU tensors take the
  plain version; CUDA tensors launch the kernel or raise.

Rounding. The encoding -sign(a)·log(|a|/size + 1e-6) jumps from 0 to ±13.8
between a = 0 and the smallest nonzero `a`, and pixels that lie on a
segment's line (axis-aligned edges through pixel centres) sit exactly there,
so the last bit of `a` decides their target. The JAX package on the CPU
computes three multiply-adds as fused multiply-adds (XLA's CPU backend
contracts them at the HiSup shapes): dx·dx + dy·dy, x1 + t·dx (and
y1 + t·dy), ax·ax + ay·ay. The port does the same, so its targets and labels
agree with the JAX package bit for bit at those shapes, and the kernel
(`fmaf` at the same three places, no other contraction) agrees with this
plain version. Here a fused multiply-add is a float64 product (exact for
float32 inputs) plus a float64 add, rounded to float32; that differs from a
single rounding only when the float64 sum lands exactly on a float32 tie,
about once in 2^29 operations.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load

# the kernel stages 24 bytes per segment in dynamic shared memory; with its
# few bytes of static shared memory a block must stay within the 48 KB that
# a launch gets without opting in to more
MAX_SEGMENTS = 2040


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c for float32 tensors, rounded as a fused multiply-add."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def afm(
    lines: torch.Tensor,
    lines_valid: torch.Tensor,
    height: int,
    width: int,
    row_block: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """lines (B, L, 4) [x1, y1, x2, y2] in output-pixel coords; lines_valid
    (B, L) bool. Returns (afmap (B, 2, H, W) f32 [dx-enc, dy-enc], aflabel
    (B, H, W) int32). A sample with no valid line gets zeros."""
    B, L, _ = lines.shape
    dev, dt = lines.device, lines.dtype
    x1, y1, x2, y2 = lines.unbind(-1)
    dx = x2 - x1
    dy = y2 - y1
    den = _fma(dx, dx, dy * dy) + 1e-6  # (B, L)
    lx1, ly1 = x1[:, None, None, :], y1[:, None, None, :]
    ldx, ldy, lden = dx[:, None, None, :], dy[:, None, None, :], den[:, None, None, :]
    valid = lines_valid.to(torch.bool)[:, None, None, :]
    px = torch.arange(width, dtype=dt, device=dev)[None, None, :, None]

    def enc(a, size):
        return -torch.sign(a) * torch.log(torch.abs(a / size) + 1e-6)

    ex, ey, lab = [], [], []
    for h0 in range(0, height, row_block):
        py = torch.arange(h0, min(h0 + row_block, height), dtype=dt, device=dev)[None, :, None, None]
        t = ((px - lx1) * ldx + (py - ly1) * ldy) / lden  # (B, R, W, L)
        t = t.clamp(0.0, 1.0)
        ax = _fma(t, ldx, lx1) - px
        ay = _fma(t, ldy, ly1) - py
        dist = torch.where(valid, _fma(ax, ax, ay * ay), torch.inf)
        idx = dist.argmin(dim=-1, keepdim=True)  # first minimum
        ex.append(enc(torch.take_along_dim(ax, idx, dim=-1)[..., 0], float(width)))
        ey.append(enc(torch.take_along_dim(ay, idx, dim=-1)[..., 0], float(height)))
        lab.append(idx[..., 0].to(torch.int32))
    afmap = torch.stack([torch.cat(ex, dim=1), torch.cat(ey, dim=1)], dim=1)
    aflabel = torch.cat(lab, dim=1)
    any_valid = lines_valid.to(torch.bool).any(dim=1)
    afmap = torch.where(any_valid[:, None, None, None], afmap, 0.0)
    aflabel = torch.where(any_valid[:, None, None], aflabel, 0)
    return afmap, aflabel


def afm_cuda(
    lines: torch.Tensor, lines_valid: torch.Tensor, height: int, width: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch `csrc/afm.cu` on the current stream. Same contract as `afm`."""
    if not lines.is_cuda:
        raise ValueError("afm_cuda takes CUDA tensors; the plain version is ops.afm.afm")
    if lines.dtype != torch.float32 or lines.dim() != 3 or lines.shape[-1] != 4:
        raise ValueError(f"lines must be float32 (B, L, 4), got {lines.dtype} {tuple(lines.shape)}")
    B, L, _ = lines.shape
    if lines_valid.dtype != torch.bool or tuple(lines_valid.shape) != (B, L):
        raise ValueError(f"lines_valid must be bool {(B, L)}, got {lines_valid.dtype} {tuple(lines_valid.shape)}")
    if lines_valid.device != lines.device:
        raise ValueError("lines and lines_valid must be on the same device")
    if not (lines.is_contiguous() and lines_valid.is_contiguous()):
        raise ValueError("afm_cuda takes contiguous tensors")
    if L > MAX_SEGMENTS:
        raise ValueError(f"afm_cuda stages at most {MAX_SEGMENTS} segments per sample in shared memory, got {L}")
    lib = load("afm")
    fn = lib.afm_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    afmap = torch.empty((B, 2, height, width), dtype=torch.float32, device=lines.device)
    label = torch.empty((B, height, width), dtype=torch.int32, device=lines.device)
    with torch.cuda.device(lines.device):
        err = fn(
            lines.data_ptr(), lines_valid.data_ptr(), afmap.data_ptr(), label.data_ptr(),
            B, L, int(height), int(width), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"afm kernel launch failed with CUDA error {err}")
    afm_cuda.launches += 1
    return afmap, label


afm_cuda.launches = 0


def afm_auto(lines, lines_valid, height: int, width: int):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if lines.is_cuda:
        return afm_cuda(lines, lines_valid, height, width)
    if lines.device.type == "cpu":
        return afm(lines, lines_valid, height, width)
    raise ValueError(f"afm: no version for device {lines.device}")
