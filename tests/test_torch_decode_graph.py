"""Pix2Poly's KV-cached greedy decode on the card, its steps replayed from
one captured CUDA graph, against the same step run as it is, bit for bit,
under the entry points' deterministic set-up. This file imports neither JAX nor the
JAX package, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_decode_graph.py

Without a card the test skips: a CUDA graph has no CPU mode.
"""

import pytest
import torch


@pytest.mark.cuda
@pytest.mark.parametrize("eos", [False, True])
def test_decode_graph_replays_equal_the_loop(eos):
    """The tiny early-fusion Pix2Poly of `graft_entry_torch` at float32
    (chip_smoke.py holds the full-width model at both dtypes): the fixed
    length, and the early exit with EOS's bias raised so rows stop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    import graft_entry_torch as g
    from pixelspointspolygons_torch.device import set_deterministic
    from pixelspointspolygons_torch.models.pix2poly import greedy_decode
    from pixelspointspolygons_torch.models.pix2poly.model import _greedy_decode

    dev = torch.device("cuda")
    found = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark, torch.utils.deterministic.fill_uninitialized_memory)
    set_deterministic(dev)
    try:
        model = g.tiny_pix2poly(torch.Generator().manual_seed(0)).to(dev).eval()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in g.dryrun_batches(3)["pix2poly"].items()
                 if k in ("images", "lidar", "lidar_mask")}
        steps = model.max_len - 1
        with torch.inference_mode():
            enc = model.encode(batch)
            if eos:  # rows stop at different steps: EOS's bias raised
                model.decoder.output.bias[33] += 0.5
            eos_code = 33 if eos else None
            loop = _greedy_decode(model, enc, 32, steps, eos_code, capture=False)
            replayed = greedy_decode(model, enc, 32, steps, eos_code=eos_code)
            again = greedy_decode(model, enc, 32, steps, eos_code=eos_code)
        torch.cuda.synchronize()
        for got in (replayed, again):
            assert torch.equal(got[0], loop[0]) and got[2] == loop[2]
            assert torch.equal(got[1].view(torch.int32), loop[1].view(torch.int32))
        assert (loop[0] != 34).any()  # tokens were generated
    finally:
        torch.use_deterministic_algorithms(found[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = found[1], found[2]
        torch.utils.deterministic.fill_uninitialized_memory = found[3]
