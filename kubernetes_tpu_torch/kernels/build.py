"""Build and load the batch-pass kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, keyed by a hash of the sources and
flags, under ``kernels/_build/`` (listed in .gitignore), then loaded with
ctypes.  Builds of several sources run as parallel ``nvcc`` processes.
A library exports one ``<entry>_launch`` per entry point (``spread_eval``,
``preempt``, ``preempt_search``, ``rows`` and ``image_locality`` have several;
``volume_filters`` holds ``vol_filter``, ``truncate`` holds
``truncate_feasible``) and one ``<name>_error_string``.  There is no
fallback: a missing compiler, a failed build or a failed load raises.
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
    "node_filters", "spread_eval", "preempt", "preempt_search", "victims", "rows", "pinned",
    "volume_filters", "image_locality", "truncate",
)
# Entry point → the library (source) that holds it.
_MULTI = {
    "eval_chunk": ("eval_chunk", "eval_chunk_cols"),
    "ipa_eval": ("ipa_eval", "ipa_eval_cols"),
    "spread_eval": ("spread_filter", "late_scores", "late_scores_cols"),
    "preempt": ("preempt_eval", "preempt_pick", "preempt_commit"),
    "preempt_search": ("dom_release", "search_step"),
    "victims": ("unpack_victims",),
    "rows": ("scatter_rows", "expand_rows"),
    "pinned": ("pinned_fit",),
    "volume_filters": ("vol_filter",),
    "image_locality": ("image_counts", "image_scores"),
    "truncate": ("truncate_feasible",),
}
ENTRIES = {name: name for name in KERNELS if name not in _MULTI}
ENTRIES.update({entry: src for src, entries in _MULTI.items() for entry in entries})

_SRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
# -fmad=false: no multiply-add contraction, so the f64 BalancedAllocation
# and RequestedToCapacityRatio scores and the f32 LearnedScorer round like
# the reference's separate multiply and add; the kernels write fma()/fmaf()
# where the reference's compiled code fuses one.  No --use_fast_math:
# division stays IEEE.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
# argtypes of each launcher (pointers and the stream as c_void_p so ctypes
# never truncates them to 32 bits).
_SIGNATURES: dict[str, list] = {
    "build_dom": [_P] * 4 + [_I] * 9 + [_P, _P, _P],
    "eval_chunk": [_P] * 37 + [_I] * 3 + [_P] * 6 + [_I] * 3 + [_P, _I]
                  + [_P, _I, _I, _P, _I, _P, _I, _I, _L, _I, _L, _L, _L, _L, _L, _I, _L, _I, _I, _I, _I]
                  + [_I, _I] + [_P] * 4,
    "eval_chunk_cols": [_P] * 37 + [_I] * 3 + [_P] * 6 + [_I] * 3 + [_P, _I]
                       + [_P, _I, _I, _P, _I, _P, _I, _I, _L, _I, _L, _L, _L, _L, _L, _I, _L, _I, _I, _I, _I]
                       + [_I] + [_P] * 4 + [_I, _P],
    "ipa_eval": [_I] * 10 + [_L] + [_P] * 30 + [_I, _I, _P],
    "ipa_eval_cols": [_I] * 10 + [_L] + [_P] * 31 + [_I, _I, _P],
    "select_host": [_P, _P, _P, _U, _P, _I, _I, _P, _P, _P, _P, _I, _P],
    "truncate_feasible": [_P] * 5 + [_I] * 5 + [_P] * 3,
    "resolve_commit": [_P, _P, _P, _I] + [_P] * 34 + [_I] * 12 + [_P, _P],
    "conflict_pairs": [_P] * 13 + [_I] * 11 + [_P, _P],
    "node_filters": [_P] * 37 + [_I] * 25 + [_P],
    "vol_filter": [_P] * 11 + [_I] * 7 + [_P],
    "spread_filter": [_P] * 15 + [_I] * 8 + [_P],
    "late_scores": [_P] * 30 + [_I] * 13 + [_L] * 3 + [_I, _I, _P],
    "late_scores_cols": [_P] * 30 + [_I] * 13 + [_L] * 3 + [_I, _I, _P],
    # preempt_eval and search_step: a pointer table and its length, the
    # dimensions and their count (preempt_search.cuh), for preempt_eval
    # its lanes a node and threads a block (kernels.eval_split), the stream.
    "preempt_eval": [_P, _I, _P, _I, _I, _I, _P],
    "dom_release": [_P] * 7 + [_I] * 8 + [_P] * 3,
    "search_step": [_P, _I, _P, _I, _P],
    "preempt_pick": [_P] * 6 + [_I] * 6 + [_P] * 4,
    "preempt_commit": [_P, _I, _I, _I] + [_P] * 11,
    "unpack_victims": [_P] + [_I] * 8 + [_P] * 6 + [_I, _P, _P, _P],
    "scatter_rows": [_P, _P],  # a FieldTable (rows.cu), the stream
    "expand_rows": [_P] * 2 + [_L] * 2 + [_P],
    "pinned_fit": [_P] * 8 + [_I] * 3 + [_P] * 3,
    "image_counts": [_P, _P, _I, _I, _I, _P, _P],
    "image_scores": [_P] * 8 + [_I] * 5 + [_P] * 3 + [_I] * 3 + [_P, _P],
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
