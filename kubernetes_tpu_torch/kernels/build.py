"""Build and load the batch-pass kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, keyed by a hash of the sources and
flags, under ``kernels/_build/`` (listed in .gitignore), then loaded with
ctypes.  Builds of several sources run as parallel ``nvcc`` processes.
A library exports one ``<entry>_launch`` per entry point (``spread_eval``,
``preempt`` and ``rows`` have several; ``volume_filters`` holds
``vol_filter``) and one ``<name>_error_string``.  There is no fallback: a missing
compiler, a failed build or a failed load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

KERNELS = (
    "build_dom", "eval_chunk", "ipa_eval", "select_host", "resolve_commit", "conflict_pairs",
    "node_filters", "spread_eval", "preempt", "victims", "rows", "pinned", "volume_filters",
)
# Entry point → the library (source) that holds it.
_MULTI = {
    "spread_eval": ("spread_filter", "late_scores"),
    "preempt": ("preempt_eval", "preempt_pick", "preempt_commit"),
    "victims": ("unpack_victims",),
    "rows": ("scatter_rows", "expand_rows"),
    "pinned": ("pinned_fit",),
    "volume_filters": ("vol_filter",),
}
ENTRIES = {name: name for name in KERNELS if name not in _MULTI}
ENTRIES.update({entry: src for src, entries in _MULTI.items() for entry in entries})

_SRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
# -fmad=false: no multiply-add contraction, so the f64 BalancedAllocation
# score rounds like the reference's separate multiply and add.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
# argtypes of each launcher (pointers and the stream as c_void_p so ctypes
# never truncates them to 32 bits).
_SIGNATURES: dict[str, list] = {
    "build_dom": [_P] * 4 + [_I] * 5 + [_P, _P, _P],
    "eval_chunk": [_P] * 22 + [_P, _I, _I, _P, _I, _I, _L, _I, _L, _I, _I, _L, _I, _I, _I, _P, _P, _P, _P],
    "ipa_eval": [_I] * 10 + [_L] + [_P] * 30 + [_I, _P],
    "select_host": [_P, _P, _P, _U, _P, _I, _I, _P, _P, _P, _P],
    "resolve_commit": [_P, _P, _P, _I] + [_P] * 24 + [_I] * 9 + [_P, _P],
    "conflict_pairs": [_P] * 10 + [_I] * 9 + [_P, _P],
    "node_filters": [_P] * 36 + [_I] * 23 + [_P],
    "vol_filter": [_P] * 11 + [_I] * 7 + [_P],
    "spread_filter": [_P] * 15 + [_I] * 7 + [_P],
    "late_scores": [_P] * 30 + [_I] * 13 + [_L] * 3 + [_I, _P],
    "preempt_eval": [_P] * 21 + [_I] * 6 + [_P] * 7,
    "preempt_pick": [_P] * 6 + [_I] * 3 + [_P] * 3,
    "preempt_commit": [_P, _I, _I, _I] + [_P] * 11,
    "unpack_victims": [_P] + [_I] * 8 + [_P] * 7,
    "scatter_rows": [_P] * 3 + [_L] * 4 + [_P],
    "expand_rows": [_P] * 2 + [_L] * 2 + [_P],
    "pinned_fit": [_P] * 8 + [_I] * 3 + [_P] * 3,
}

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or PATH."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(_SRC.glob("*.cuh")) + [_SRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every named kernel whose library is missing, all nvcc
    processes started together.  Returns each compiled kernel's compiler
    output (ptxas register and shared-memory report); raises with the
    compiler's output when a build fails."""
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    _BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(_SRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
        )
    logs, failed = {}, []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
            os.unlink(tmp)
        else:
            os.replace(tmp, _target(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_target(name)))
        for entry, src in ENTRIES.items():
            if src == name:
                fn = getattr(lib, f"{entry}_launch")
                fn.argtypes = _SIGNATURES[entry]
                fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def launch(entry: str, *args) -> None:
    """Call one entry point's launcher; raise on a non-zero cudaGetLastError()."""
    name = ENTRIES[entry]
    lib = library(name)
    rc = getattr(lib, f"{entry}_launch")(*args)
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc} ({msg})")
