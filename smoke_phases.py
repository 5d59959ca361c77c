"""Time `chip_smoke.py`'s first phases alone, for one checkout of the repo.

Usage (on a machine with a CUDA card):

    python3 smoke_phases.py TREE

It runs TREE's `chip_smoke.py` `main()` as far as the end of phase 3, the
way the full run does: the deterministic set-up, phase 1-2 (the host, the
kernels' build and the trained prebuild started beside the next phases)
and phase 3 (the AFM, pillar-sums and run-sums kernels against their plain
versions), then prints `PHASES {"tree": ..., "1-2": s, "3": s}` as its last
line. To compare two trees' start-up cost, unpack both (`git archive`),
empty each tree's `build/` before each run, so that every run builds its
kernels and data anew, and run them in turns: parent, change, change,
parent, and so on.
"""

import json
import os
import sys

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import chip_smoke as cs  # noqa: E402  (TREE's, not this checkout's)

os.environ["P3_DATASET_ROOT"] = os.path.join(cs.WORK, "data")
os.environ["P3_MODEL_ROOT"] = os.path.join(cs.WORK, "outputs")
from pixelspointspolygons_torch.config import compose  # noqa: E402
from pixelspointspolygons_torch.device import set_deterministic, set_tf32  # noqa: E402

if not cs.torch.cuda.is_available():
    cs.fail("no CUDA device: this script times chip_smoke.py's phases on the card")
set_deterministic(cs.CARD)
set_tf32(False)
print(f"card: {cs.phase_host()}", flush=True)
cs.check_deterministic("deterministic set-up, for every phase")
cs.phase_build()
cs.start_trained_prebuild()
cs.phase_done("1-2")
cs.phase_afm(compose(cs.smoke_overrides(cs.TRAIN_STEPS * cs.B)))
cs.phase_pillar_sums()
cs.phase_run_sums()
cs.phase_done("3")
print("PHASES " + json.dumps({"tree": sys.argv[1], **{k: round(v, 1) for k, v in cs.PHASE_S.items()}}), flush=True)
