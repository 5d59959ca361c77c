"""On the card: the control, the reference with TF32 products in the
program's place, comes out not correct in each cell, at the cells' widths
and with fewer tiles; the program itself comes out correct; and each fault
a cell can have, planted in the program's timed path, fails a number.

    python -m pytest -m cuda benchmark/tests/test_p3bench_control.py"""

from __future__ import annotations

import copy
import tempfile

import pytest

from benchmark.control import readings
from benchmark.harness.spec import cell_spec, driver, load_benchmark


@pytest.fixture
def card(tmp_path, monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: TF32, the control's precision, exists only there")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


def _fewer_tiles(cell: str) -> dict:
    s = copy.deepcopy(cell_spec(load_benchmark(), cell))
    tr = s["traffic"]
    tr["splits"] = {k: v and (48 if k == "train" else 16) for k, v in tr["splits"].items()}
    tr["check_tiles"] = 16
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["p2p_image.predict", "p2p_fusion.train"])
def test_the_control_is_not_correct(card, cell):
    s = _fewer_tiles(cell)
    out = readings(s, 2**31 + 77, None)
    limits = driver(s["traffic"]["mode"]).LIMITS
    assert all(out["program"][k] <= v for k, v in limits.items() if v is not None), out
    assert any(out["control"][k] > v for k, v in limits.items() if v is not None), out


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", [("p2p_image.predict", "half_batch"), ("p2p_image.predict", "token"),
                                        ("p2p_image.predict", "decode_token"), ("p2p_fusion.train", "half_batch"),
                                        ("p2p_fusion.train", "unchanged"), ("p2p_fusion.train", "token")])
def test_a_fault_is_not_correct(card, cell, fault):
    s = _fewer_tiles(cell)
    out = readings(s, 2**31 + 78, fault)
    limits = driver(s["traffic"]["mode"]).LIMITS
    assert any(out["program"][k] > v for k, v in limits.items() if v is not None), out
