"""Build, load and count the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface, loaded with `ctypes`. The
build happens at first use (or all at once through `build()`, which
starts one `nvcc` per source in parallel), into `_build/` beside
`csrc/`, keyed by a hash of the source, of the shared headers it
includes (`csrc/*.cuh`) and of the flags, so an edited source or header
rebuilds and an unchanged one loads at once.

Every kernel wrapper calls `count_launch(name)` right where it launches
its kernel, and nowhere else, so a run can show that its main path went
through the kernels (`launch_counts()` / `reset_launch_counts()`). A
source holding several kernels counts each under its own name
(`LAUNCHES`); a flash kernel counts every launch under its name
("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") and those of its wgmma
variant also under "<name>_wgmma"; the dequant-matmul counts every
launch under "dqmm", those of its prefill kernel also under "dqmm_ws"
and those of its TMA-ring decode kernel under "dqmm_decode_tma"; the
paged attention counts every launch under "paged_attention" and those of
its TMA-ring kernel also under "paged_attention_tma".

The two decode kernels that share their work evenly over a fixed grid
sum a run of work that several blocks shared in the last block to finish
it, found by a counter per run: `zeroed_counters` holds one zeroed int32
buffer per device for them, which each launch leaves zero again.
"""

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("flash_fwd", "flash_bwd", "paged_attention", "quant_int8",
           "dequant_int8", "dqmm")
# the launch counters of each source (a source not named here holds one
# kernel, counted under the source's name)
LAUNCHES = {"flash_fwd": ("flash_fwd", "flash_fwd_wgmma"),
            "flash_bwd": ("flash_bwd_dq", "flash_bwd_dq_wgmma",
                          "flash_bwd_dkv", "flash_bwd_dkv_wgmma"),
            "paged_attention": ("paged_attention", "paged_attention_tma"),
            "dqmm": ("dqmm", "dqmm_ws", "dqmm_decode_tma")}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[Tuple[str, str], Any] = {}
_LAUNCHES: Dict[str, int] = {
    name: 0 for src in KERNELS for name in LAUNCHES.get(src, (src,))
}


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


# the SMs of an H100 SXM: the launch plans' default where no card is asked
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    """The SMs of CUDA device `device` (the launch plans size grids by)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


_COUNTERS: Dict[int, Any] = {}
# counters kept at first use: enough for every output tile of a 262144
# vocabulary's lm_head and every (row, KV head) of a 1024-slot batch,
# so a CUDA graph captured later never grows the buffer
_MIN_COUNTERS = 8192


def zeroed_counters(device: int, n: int):
    """An int32 buffer of at least `n` zeros on CUDA device `device`,
    the same one for every launch there (grown, never shrunk). The
    kernels that take it leave it zero, so launches that use it must
    not overlap: one stream per device."""
    import torch

    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, _MIN_COUNTERS), dtype=torch.int32,
                          device=torch.device("cuda", device))
        _COUNTERS[device] = buf
    return buf


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels "
            "are built from csrc/ on the machine with the card"
        )
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(path: Path, seen: Optional[set] = None) -> list:
    """`path` and every file of `csrc/` it includes with `#include "..."`,
    transitively, each once, in the order they are first met."""
    seen = set() if seen is None else seen
    if path in seen:
        return []
    seen.add(path)
    found = [path]
    for inc in _INCLUDE.findall(path.read_bytes()):
        dep = path.parent / inc.decode()
        if dep.is_file():
            found += _sources(dep, seen)
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in _sources(CSRC / f"{name}.cu"):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile every named kernel whose library is missing, one `nvcc`
    per source, all started together. Returns {name: {"seconds",
    "log"}} (log = nvcc's stderr, which holds the -Xptxas=-v register
    and shared-memory report). Raises on any failed compile."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        # unique temp name, renamed into place: two processes building
        # at once never load a half-written library
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            ),
            tmp,
            out,
        )
    report = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        report[name] = {
            "seconds": time.perf_counter() - t0,
            "log": stdout + stderr,
        }
        if proc.returncode != 0:
            failed.append(f"{name}:\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def function(name: str, symbol: str, argtypes: Sequence) -> Any:
    """The C function `symbol` of kernel library `name` (built and
    loaded first if needed), returning int, with its argument types set
    once: a per-call wrapper then pays only the call itself."""
    fn = _FNS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _FNS[(name, symbol)] = fn
    return fn


def current_stream(device_index: int) -> int:
    """The raw handle of the current CUDA stream of a device, for a
    launch: the call torch's own kernel launchers make, a fraction of
    the host time of `torch.cuda.current_stream(device).cuda_stream`
    (which matters where a decode step launches hundreds of kernels)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device_index)


def check(err: int, name: str, what: Optional[str] = None) -> None:
    """Raise on a non-zero `cudaGetLastError()` code from a launch."""
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed with CUDA error {err}"
            + (f" ({what})" if what else "")
        )
