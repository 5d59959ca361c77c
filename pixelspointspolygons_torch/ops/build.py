"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`) into a
shared library with a plain C interface and loaded with ctypes. A library is
built at first use, into `build/torch_kernels/` under the repository root,
under a name that carries a hash of its source and flags, so an edited
source is never served by a stale build. `build()` compiles several sources
at once, one `nvcc` process each, all started together;
`compile_versions()` does the same for the kernel benchmarks' variants
(other copies of a source, or other `-D` settings), with ptxas's usage of
each.

No CUDA toolkit is needed to import this module; only building needs one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

# kernel name -> source file under csrc/
SOURCES = {"afm": "afm.cu", "pillar_sums": "pillar_sums.cu", "run_sums": "run_sums.cu"}

# --fmad=false and IEEE division/sqrt: the kernels keep their plain
# versions' rounding (see the note at the top of each source)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "--fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: building the port's CUDA kernels needs the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, SOURCES[name])
    h = hashlib.sha1()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names=None) -> dict:
    """Compile the named kernels (all by default) that are not built yet,
    in parallel. Returns {name: {"seconds": s, "log": nvcc's stderr}} for
    the ones compiled, whose log is also kept beside the library
    (`library_path(name) + ".log"`); raises on the first failure, after all
    have ended."""
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if os.path.isfile(out):
            continue
        nvcc = nvcc or nvcc_path()
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    results, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        with open(f"{out}.log", "w") as f:  # ptxas's registers, shared memory and spills, kept beside the library
            f.write(log)
        os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
        results[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return results


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if needed."""
    path = library_path(name)
    if not os.path.isfile(path):
        build([name])
    return ctypes.CDLL(path)


def ptxas_usage(log: str, kernel: str) -> dict:
    """{entry function: its registers, shared memory and spills} for each
    entry of `-Xptxas -v`'s log whose mangled name holds `kernel`."""
    usage, entry = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            entry = found.group(1) if kernel in found.group(1) else None
        elif entry and ("registers" in line or "spill" in line):
            usage.setdefault(entry, []).append(line.split(":", 1)[-1].strip() if "Used" in line else line.strip())
    return {k: "; ".join(v) for k, v in usage.items()}


def compile_versions(sources: dict, out_dir: str, kernel: str) -> dict:
    """{name: (.cu path, extra nvcc flags)} -> {name: .so path}: each built
    with the port's flags into `out_dir`, one nvcc each, all started
    together; prints ptxas's usage of each entry function whose name holds
    `kernel`. Raises on the first failure, after all have ended."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, (src, defines) in sources.items():
        so = os.path.join(out_dir, f"lib{name}.so")
        cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", so, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs, failed = {}, []
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{log}")
            continue
        for entry, usage in ptxas_usage(log, kernel).items():
            print(f"built {name}: {entry}: {usage}", flush=True)
        libs[name] = so
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs
