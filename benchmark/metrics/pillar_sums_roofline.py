"""pillar_sums_roofline (%): the least time of the traced epoch's pillar sums
(`csrc/pillar_sums.cu`; bytes by `counts/bytes.py`: the kept points and the
per-pillar sums and counts, at 3.35 TB/s) over their device time in the
trace."""

from benchmark.counts import bytes as nbytes
from benchmark.harness.trace import kernel_seconds


def read(data):
    tr = data["trace"] or {}
    work = tr.get("lidar")
    seconds, launches = kernel_seconds(tr, "pillar_sums_kernel")
    if not work or not launches:
        return None
    need = nbytes.pillar_sums(work["kept_points"], work["samples"] * work["steps"], work["cells"])
    return 100.0 * nbytes.least_seconds(need) / seconds
