"""The reference against the port on the CPU at a tiny size: both cells run
whole (set-up, window, comparison) and come out correct, and each fault
that a cell can have, planted in the timed path, makes `correct` false.
The reference's pillar encoder also matches the port's where most pillars
hold more points than they keep."""

from __future__ import annotations

import tempfile
import time

import pytest
import torch

from benchmark.harness.runner import run_cell
from benchmark.tests.tiny import spec

SEED = 2**31 + 12345


@pytest.fixture(autouse=True)
def _tmp(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


def _run(cell: str, fault: str | None = None):
    return run_cell(spec(cell), SEED, 0.5, False, time.perf_counter(), device="cpu", fault=fault)


@pytest.mark.parametrize("cell", ["p2p_image.predict", "p2p_fusion.train"])
def test_cell_is_correct_on_the_cpu(cell):
    result, checks = _run(cell)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert all(c.ok for c in checks), checks


@pytest.mark.parametrize("cell,fault", [("p2p_image.predict", "half_batch"), ("p2p_image.predict", "token"),
                                        ("p2p_image.predict", "decode_token"), ("p2p_fusion.train", "unchanged"), ("p2p_fusion.train", "half_batch"),
                                        ("p2p_fusion.train", "token")])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    result, checks = _run(cell, fault)
    assert not result["correct"], checks


def test_pillar_encoder_matches_the_port_past_the_cap():
    from benchmark.reference import model as ref
    from pixelspointspolygons_torch.models.pointpillars import PillarCanvas

    torch.manual_seed(0)
    B, N, cap = 2, 600, 4
    pts = torch.rand(B, N, 3) * torch.tensor([32.0, 32.0, 100.0])
    valid = torch.arange(N)[None] < torch.tensor([[500], [350]])
    port = PillarCanvas(32.0, 32.0, 8.0, 8.0, cap, feat_channels=(16, 24)).train()
    s = {"voxel_x": 8.0, "voxel_y": 8.0, "width": 32.0, "height": 32.0, "max_points_per_voxel": cap,
         "pfn_channels": [16, 24], "vit_dim": 24, "patch_size": 8, "num_patches": 16, "vit_depth": 0,
         "vit_heads": 6, "vit_mlp_ratio": 4, "decoder_dim": 24}
    mine = ref.FusionEncoder(s).train()
    state = {k: v for k, v in port.state_dict().items()}
    for k, v in state.items():
        if k.endswith("weight") and v.dim() == 2:
            state[k] = torch.randn_like(v) / v.shape[1] ** 0.5
    port.load_state_dict(state)
    mine.pillar_canvas.load_state_dict(state)
    out_port = port(pts, valid)
    out_ref, vox = mine.canvas(pts, valid)
    assert int(vox["keep"].sum()) < int(valid.sum())  # points past the cap
    torch.testing.assert_close(out_ref, out_port, rtol=1e-5, atol=1e-5)
    out_port.square().sum().backward()
    out_ref.square().sum().backward()
    for (name, a), (_, b) in zip(port.named_parameters(), mine.pillar_canvas.named_parameters()):
        torch.testing.assert_close(b.grad, a.grad, rtol=1e-4, atol=1e-5, msg=name)
