"""Build and load the port's CUDA kernels (``csrc/*.cu``: nine sources,
K1-K10; K4 and K6 share ``dtw_band.cu`` (three forms), and their block
form and K5's scratch form the body in ``dtw_band.cuh``; K8 and K2's full
form the body in ``lb_keogh.cuh``).

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a``; the objects are linked into one shared library with a
plain C interface and loaded with ``ctypes``.  The build runs at first use
(never at import: the package imports on machines without a compiler),
into ``build/repro_torch/`` at the repository root, keyed by a hash of the
sources and flags so an edited kernel is never served from a stale build.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_SIGNATURES = {
    # name: (argtypes, restype)
    "envelope_launch": ([_P, _P, _P, _P, _I, _LL, _I, _I, _P], _I),
    "lb_enhanced_launch": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
                           _I),
    "lb_enhanced_pairwise_launch": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                     _P], _I),
    "dtw_band_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "dtw_band_step_launch": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    "dtw_band_block_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "dtw_band_step_block_launch": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    "dtw_band_slots_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "dtw_band_step_slots_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _P],
                                   _I),
    "dtw_band_stream_rows_launch": ([_P, _P, _P, _P, _LL, _I, _I, _I, _P],
                                    _I),
    "dtw_band_stream_cluster_launch": ([_P, _P, _P, _P, _LL, _I, _I, _I, _I,
                                        _P], _I),
    "dtw_band_stream_scratch_launch": ([_P, _P, _P, _P, _P, _I, _LL, _I, _I,
                                        _I, _P], _I),
    "sketch_bound_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "sketch_bound_smem_bytes": ([_I], ctypes.c_longlong),
    "sketch_bound_occupancy": ([_I], _I),
    "lb_keogh_launch": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    "flash_attention_bf16_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _I, _I, _F, _F, _P], _I),
    "flash_attention_cuda_cores_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                           _I, _I, _I, _F, _F, _I, _P], _I),
    "flash_attention_cuda_cores_occupancy": ([_I], _I),
    "mamba_scan_launch": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _P], _I),
    "mamba_scan_wide_launch": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _P], _I),
    "mamba_scan_occupancy": ([_I], _I),
    "dtw_band_warp_occupancy": ([_I, _I], _I),
    "dtw_band_slots_occupancy": ([_I, _I, _I], _I),
    "rt_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the repro_torch CUDA kernels are built at first "
        "use and need the CUDA toolkit"
    )


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def build_key() -> str:
    """Hash of every kernel source, header and flag."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in sorted(_CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library's path.  Raises with nvcc's output when a build fails."""
    target = _BUILD_DIR / f"librepro_torch_{build_key()}.so"
    if target.exists():
        return target
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for src, _, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{log}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        lib_tmp = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *_FLAGS, "-shared", "-o", str(lib_tmp),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib_tmp, target)          # atomic against racing builds
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise when a launch function reported a CUDA error."""
    if rc != 0:
        msg = library().rt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} at launch ({msg})")


# Launches of each kernel: its wrapper adds one per launch, nowhere else,
# so a run can show that a path went through the kernel.
COUNTS: dict[str, int] = dict.fromkeys(
    ("envelope", "lb_enhanced", "lb_enhanced_full", "lb_enhanced_pairwise",
     "dtw_band", "dtw_band_slots", "dtw_band_block", "dtw_band_stream",
     "dtw_band_stream_cluster", "dtw_band_stream_scratch", "dtw_band_step",
     "dtw_band_step_slots", "dtw_band_step_block",
     "sketch_bound", "lb_keogh", "flash_attention",
     "flash_attention_f32", "mamba_scan", "mamba_scan_wide"), 0)


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def counts() -> dict[str, int]:
    return dict(COUNTS)
