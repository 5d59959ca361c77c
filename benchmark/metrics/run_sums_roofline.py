"""run_sums_roofline (%): the least time of the traced epoch's run sums
(`csrc/run_sums.cu`; bytes by `counts/bytes.py`: every row's id, the kept
points' rows and the pillars' sums once a launch, at 3.35 TB/s) over their
device time in the trace."""

from benchmark.counts import bytes as nbytes
from benchmark.harness.trace import kernel_seconds


def read(data):
    tr = data["trace"] or {}
    work = tr.get("lidar")
    seconds, launches = kernel_seconds(tr, "run_sums_kernel")
    if not work or not launches:
        return None
    need = nbytes.pfn_run_sums(work["kept_points"], work["rows"], work["pillars"], data["sizes"]["pfn_channels"])
    return 100.0 * nbytes.least_seconds(need) / seconds
