"""The host C++/OpenMP cell-list pair counter, bound with ctypes.

The port's copy of ``tabcorr_tpu/native.py``: the same labeled-histogram
interface as :func:`tabcorr_tpu_torch.ops.paircount.labeled_pair_count`,
counted on the host in float64 geometry by ``native_src/paircount.cpp``
(the JAX package's source, copied unchanged) -- the CPU production path
of the JAX package, and the role Corrfunc plays for the reference.  Only
``labeled_pair_count(strategy="native")`` and ``tabulate(backend=
"native")`` reach it.

The library is built from the checkout's source at first use, with the
system g++, into ``build/native/`` at the root of the checkout, named by a
hash of the source, the flags and the host's CPU flags (it is compiled
with ``-march=native``: a copy of the checkout on another machine builds
its own).  A build links to a private name and renames it into place, so
concurrent first uses (pytest-xdist workers) never load a half-written
file.  Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native_src" / "paircount.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp",
             "-march=native")
# tabcorr_native_version() of native_src/paircount.cpp: the C ABI the
# ctypes signature below expects.
NATIVE_ABI_VERSION = 3
KINDS = {"rppi": 0, "proj": 1, "smu": 2}
PAIR_WEIGHTS = {"unit": 0, "log_rp": 1, "unit+log_rp": 2}


class NativeUnavailable(RuntimeError):
    """The C++ counter could not be built or loaded."""


def _cpu_flags() -> str:
    """The host's CPU flags line (what ``-march=native`` compiles for)."""
    try:
        with open("/proc/cpuinfo") as stream:
            for line in stream:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    return platform.processor()


def library_path() -> Path:
    """Where the library of the current source, flags and host is built."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    digest.update(f"{platform.machine()} {_cpu_flags()}".encode())
    return BUILD_DIR / f"libtabcorr_paircount-{digest.hexdigest()[:16]}.so"


def _build(lib_path: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, lib_path)
    except (subprocess.CalledProcessError, OSError) as exc:
        tmp.unlink(missing_ok=True)
        detail = getattr(exc, "stderr", None) or str(exc)
        raise NativeUnavailable(
            f"could not build the native pair counter ({' '.join(cmd)}): "
            f"{detail}") from exc


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build the library unless it is there (:func:`library_path`), load
    it and check its ABI version."""
    lib_path = library_path()
    if not lib_path.exists():
        _build(lib_path)
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError as exc:
        raise NativeUnavailable(f"could not load {lib_path}: {exc}") from exc
    lib.tabcorr_native_version.restype = ctypes.c_int
    found = int(lib.tabcorr_native_version())
    if found != NATIVE_ABI_VERSION:
        raise NativeUnavailable(
            f"{lib_path.name} reports ABI version {found}, expected "
            f"{NATIVE_ABI_VERSION}: native_src/paircount.cpp and native.py "
            "are out of step.")
    dp, ip = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32)
    lib.tabcorr_count_pairs.restype = None
    lib.tabcorr_count_pairs.argtypes = [
        dp, ip, ctypes.c_int64,          # pos1, labels1, n1
        dp, ip, dp, ctypes.c_int64,      # pos2, labels2, weights2, n2
        ctypes.c_int,                    # autocorr
        ctypes.c_int, ctypes.c_int,      # n_labels_1, n_labels_2
        dp, ctypes.c_int,                # r_edges_sq, n_r
        ctypes.c_double, ctypes.c_int,   # pi_max, n_mu
        dp,                              # period (3,)
        ctypes.c_int,                    # kind
        ctypes.c_int,                    # pair_weight (2: two channels)
        dp,                              # out
    ]
    return lib


def native_available() -> bool:
    """Whether the C++ counter builds and loads on this host."""
    try:
        load_library()
    except NativeUnavailable:
        return False
    return True


def labeled_pair_count(pos1, labels1, n_labels_1, pos2=None, labels2=None,
                       n_labels_2=None, weights2=None, period=1.0,
                       kind="rppi", r_edges=None, pi_max=None,
                       mu_edges=None, pair_weight="unit"):
    """The C++ twin of :func:`tabcorr_tpu_torch.ops.paircount.
    labeled_pair_count` (the same arguments and result), in float64
    geometry on the host.  It takes uniform mu bins from 0 to 1 only, and
    'rppi' needs ``pi_max``."""
    if kind not in KINDS:
        raise ValueError(f"Unknown kind {kind!r}; use one of {tuple(KINDS)}.")
    if pair_weight not in PAIR_WEIGHTS:
        raise ValueError(f"Unknown pair_weight {pair_weight!r}.")
    if kind == "rppi" and pi_max is None:
        # The C++ counter would read pi_max = 0 and count nothing.
        raise ValueError("kind='rppi' requires pi_max.")
    period = np.ascontiguousarray(
        np.broadcast_to(np.asarray(period, dtype=np.float64), (3,)))
    r_edges = np.ascontiguousarray(r_edges, dtype=np.float64)
    n_r = len(r_edges) - 1
    if kind == "smu":
        # The C++ counter bins mu as floor(mu * n_mu).
        mu_edges = np.asarray(mu_edges, dtype=np.float64)
        if not np.allclose(mu_edges, np.linspace(0, 1, len(mu_edges))):
            raise ValueError("The native backend requires uniform mu bins "
                             "from 0 to 1.")
        n_mu = len(mu_edges) - 1
    else:
        n_mu = 1
    lib = load_library()

    auto = pos2 is None
    pos1 = np.ascontiguousarray(pos1, dtype=np.float64).reshape(-1, 3)
    labels1 = np.ascontiguousarray(labels1, dtype=np.int32)
    if auto:
        pos2, labels2, n_labels_2 = pos1, labels1, n_labels_1
    else:
        pos2 = np.ascontiguousarray(pos2, dtype=np.float64).reshape(-1, 3)
        # labels2=None stays a NULL pointer: the counter gives every
        # j-tracer label 0.
        if labels2 is not None:
            labels2 = np.ascontiguousarray(labels2, dtype=np.int32)
        if n_labels_2 is None:
            n_labels_2 = 1 if labels2 is None else int(labels2.max()) + 1
    for labels, n_labels in ((labels1, n_labels_1), (labels2, n_labels_2)):
        if labels is not None and len(labels) and labels.max() >= n_labels:
            raise ValueError("labels must be below their n_labels.")
    if weights2 is not None:
        weights2 = np.asarray(weights2, dtype=np.float64)
        if weights2.ndim == 0:
            weights2 = np.full(len(pos2), weights2)
        weights2 = np.ascontiguousarray(weights2)
        if weights2.shape != (len(pos2),):
            raise ValueError(f"weights2 must be ({len(pos2)},).")

    n_channels = 2 if pair_weight == "unit+log_rp" else 1
    out = np.zeros(n_channels * n_labels_1 * n_labels_2 * n_r * n_mu,
                   dtype=np.float64)
    edges_sq = np.ascontiguousarray(r_edges ** 2)

    def ptr(array, ctype):
        return None if array is None else array.ctypes.data_as(
            ctypes.POINTER(ctype))

    lib.tabcorr_count_pairs(
        ptr(pos1, ctypes.c_double), ptr(labels1, ctypes.c_int32), len(pos1),
        ptr(pos2, ctypes.c_double), ptr(labels2, ctypes.c_int32),
        ptr(weights2, ctypes.c_double), len(pos2), int(auto),
        int(n_labels_1), int(n_labels_2), ptr(edges_sq, ctypes.c_double),
        n_r, float(pi_max if pi_max is not None else 0.0), n_mu,
        ptr(period, ctypes.c_double), KINDS[kind], PAIR_WEIGHTS[pair_weight],
        ptr(out, ctypes.c_double))

    shape = (n_labels_1, n_labels_2, n_r) if kind != "smu" else \
        (n_labels_1, n_labels_2, n_r, n_mu)
    if n_channels == 2:
        return out.reshape((2,) + shape)
    return out.reshape(shape)
