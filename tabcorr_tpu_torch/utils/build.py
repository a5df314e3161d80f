"""Build the port's CUDA sources into shared libraries at first use.

The kernels have a plain C interface and are loaded with ``ctypes``;
nothing includes PyTorch's headers, so a build takes seconds.  Each
library goes to ``build/kernels/`` at the root of the checkout, named by
a hash of every file under ``csrc/`` and of the compiler flags, so a
changed source builds anew and an unchanged one builds once; several
libraries build in parallel (:func:`build_libraries`).  Nothing is
compiled when a module is imported: :func:`load_library` runs on the
first launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# sm_90a (Hopper with its architecture-specific features).  No
# --use_fast_math: it would swap expf/erfcf/exp10f/log1pf for the
# approximate intrinsics and break the 1e-6 accuracy contract.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then
    /usr/local/cuda/bin/nvcc."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH.")


def _source_hash() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where the library ``name`` of the current sources is built."""
    return BUILD_DIR / f"lib{name}-{_source_hash()}.so"


def build_libraries(specs) -> None:
    """Compile every library of ``specs`` (name -> ``csrc/`` sources) that
    is not built yet: one nvcc per library, all started together.

    Each library goes to :func:`library_path`, with the compiler's
    resource report (registers, shared memory, spills per kernel) beside
    it as ``.log``.  Raises if any build fails.
    """
    builds = []
    for name, sources in specs.items():
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC / s) for s in sources)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        builds.append((out, tmp, cmd, proc))
    errors = []
    for out, tmp, cmd, proc in builds:
        report, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed with code {proc.returncode}:\n"
                          f"{' '.join(cmd)}\n{report}")
            continue
        out.with_suffix(".log").write_text(report)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


@functools.cache
def load_library(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Build ``csrc/<sources>`` into ``build/kernels/lib<name>-<hash>.so``
    unless it is already there (:func:`build_libraries`), and load it."""
    build_libraries({name: sources})
    return ctypes.CDLL(str(library_path(name)))
