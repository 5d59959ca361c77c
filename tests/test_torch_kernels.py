"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card. This file imports neither JAX nor the JAX package, so it runs
where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Without a card every test here skips: a CUDA kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

from pixelspointspolygons_torch.ops.afm import MAX_SEGMENTS, afm, afm_cuda


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _afm_inputs(seed, B, L, H, W):
    rng = np.random.RandomState(seed)
    lines = rng.uniform(0, max(H, W), (B, L, 4)).astype(np.float32)
    lines[:, ::3] = np.round(lines[:, ::3])  # endpoints on the pixel grid
    lines[:, 1::5, 2:] = lines[:, 1::5, :2]  # zero-length segments
    valid = rng.rand(B, L) < 0.7
    valid[-1] = False  # a sample with no valid segment
    return lines, valid


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,L,H,W",
    [
        (16, 256, 224, 224),  # the HiSup main path
        (3, 37, 21, 50),  # ragged last block, L not a multiple of a warp
        (2, 1, 7, 300),
        (2, MAX_SEGMENTS, 40, 24),  # the most segments the kernel stages
    ],
)
def test_afm_kernel_matches_plain(cuda_device, B, L, H, W):
    """Labels exact (the same IEEE operations in the same order, compiled
    with --fmad=false); map atol 1e-5 (the kernel's logf and torch's log may
    differ by an ulp, and |map| <= 14)."""
    lines, valid = _afm_inputs(5, B, L, H, W)
    lt, vt = torch.from_numpy(lines).to(cuda_device), torch.from_numpy(valid).to(cuda_device)
    before = afm_cuda.launches
    got_map, got_lab = afm_cuda(lt, vt, H, W)
    want_map, want_lab = afm(lt, vt, H, W)
    torch.cuda.synchronize()
    assert afm_cuda.launches == before + 1
    assert got_map.shape == (B, 2, H, W) and got_lab.shape == (B, H, W)
    assert torch.equal(got_lab, want_lab)
    assert float((got_map - want_map).abs().max()) <= 1e-5
    assert float(got_map[-1].abs().sum()) == 0 and int(got_lab[-1].abs().sum()) == 0


@pytest.mark.cuda
def test_afm_kernel_refuses_what_it_cannot_take(cuda_device):
    lines, valid = _afm_inputs(0, 2, 8, 16, 16)
    lt, vt = torch.from_numpy(lines).to(cuda_device), torch.from_numpy(valid).to(cuda_device)
    before = afm_cuda.launches
    with pytest.raises(ValueError, match="segments"):
        afm_cuda(torch.zeros(1, MAX_SEGMENTS + 1, 4, device=cuda_device),
                 torch.ones(1, MAX_SEGMENTS + 1, dtype=torch.bool, device=cuda_device), 8, 8)
    with pytest.raises(ValueError, match="float32"):
        afm_cuda(lt.double(), vt, 16, 16)
    with pytest.raises(ValueError, match="bool"):
        afm_cuda(lt, vt.float(), 16, 16)
    with pytest.raises(ValueError, match="contiguous"):
        afm_cuda(lt.transpose(0, 1).contiguous().transpose(0, 1), vt, 16, 16)
    with pytest.raises(ValueError, match="same device"):
        afm_cuda(lt, vt.cpu(), 16, 16)
    assert afm_cuda.launches == before
