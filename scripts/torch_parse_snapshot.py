"""Snapshot ingestion CLI over tabcorr_tpu_torch: raw N-body outputs ->
the database's snapshot.

The port of ``scripts/parse_snapshot.py`` (the JAX package's copy of the
reference's script) over ``tabcorr_tpu_torch``'s database: it
converts raw simulation products into the database's uniform snapshot
with tables ``halos`` and ``particles`` (one table per invocation,
appended, like the reference), written as the reference's
``snapshot.hdf5`` (h5py) or, with ``--format npz``, as ``snapshot.npz``:
the same structured arrays and each table's metadata as JSON (numpy
alone; what ``scripts/torch_tabulate_snapshot.py --format npz`` reads):

* AemulusAlpha halos: the bgc2-based catalogs ``outbgc2_{n}.list``
  (true M200b/R200b) with ``halo_rs`` merged row-wise from the matching
  ``out_{n}.list`` (reference: scripts/parse_snapshot.py:143-185).
* AemulusAlpha particles: the 512-chunk Gadget-2 snapshot download with a
  1% subsample (reference: scripts/parse_snapshot.py:188-222).
* AbacusSummit halos: CompaSO catalogs, N >= 300, box recentered by
  +BoxSize/2, r_s = rvcirc_max / 2.16258
  (reference: scripts/parse_snapshot.py:225-253).
* AbacusSummit particles: the 34-chunk ``{field,halo}_rv_A`` asdf
  A-subsample thinned to 0.025% of all particles (0.00025/0.03 of the 3%
  subsample), box recentered, with an ``htar`` tape-retrieval hook for the
  redshifts whose field files are archived
  (reference: scripts/parse_snapshot.py:256-290).

Self-contained readers: Gadget-2 format-1 binary blocks and Rockstar ASCII
halo lists.  External transports are injectable for offline testing: the
Aemulus functions take a ``fetch(relative_path) -> bytes`` callable
(default: basic-auth HTTP via env credentials, or a local --raw_dir), the
Abacus particle reader takes ``asdf_reader`` / ``tape_retrieve`` hooks
(defaults: abacusutils / htar, each raising a clear error if unavailable).

Nothing downloads at import: a fetch starts only in ``main`` or when a
caller asks for one.  Progress bars use tqdm where it is installed, else
plain lines on stderr.

Usage:
    python scripts/torch_parse_snapshot.py AemulusAlpha 0.25 --cosmo 0
    python scripts/torch_parse_snapshot.py AbacusSummit 0.5 --raw_dir ... \
        --particles --format npz
"""

import argparse
import io
import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tabcorr_tpu_torch import database  # noqa: E402
from tabcorr_tpu_torch.io import ColumnTable  # noqa: E402
from tabcorr_tpu_torch.utils.progress import \
    progress as progress_bar  # noqa: E402

GADGET_HEADER = struct.Struct("<6I6dddii6Iiiddddii6Ii")

# AemulusAlpha snapshot scale factors; a requested redshift must match one
# to within 0.005 (reference: scripts/parse_snapshot.py:152-161).
AEMULUS_SCALE_FACTORS = np.array([0.25, 0.333333, 0.5, 0.540541, 0.588235,
                                  0.645161, 0.714286, 0.8, 0.909091, 1.0])
AEMULUS_BASE_URL = "https://www.slac.stanford.edu/~jderose/aemulus/phase1"
AEMULUS_N_PARTICLE_CHUNKS = 512

# The rv_A asdf files hold a 3% subsample of all particles; the database
# keeps 0.025% of all particles, i.e. 0.00025/0.03 of the A subsample
# (reference: scripts/parse_snapshot.py:272-273).
ABACUS_A_SUBSAMPLE = 0.03
ABACUS_PARTICLE_FRACTION = 0.00025
ABACUS_N_PARTICLE_CHUNKS = 34
# NERSC tape archive holding the field_rv_A files for z = 0.3 / 0.4
# (reference: scripts/parse_snapshot.py:21, :260-265).
ABACUS_SUMMIT_PATH_TAPE = Path("/nersc/projects/desi/cosmosim/Abacus")


def aemulus_snapshot_number(redshift):
    """Snapshot index for an AemulusAlpha redshift (0.005 tolerance)."""
    redshift_snapshots = 1.0 / AEMULUS_SCALE_FACTORS - 1.0
    if np.amin(np.abs(redshift_snapshots - redshift)) >= 0.005:
        raise ValueError(f"No snapshot for redshift {redshift:.2f}.")
    return int(np.argmin(np.abs(redshift_snapshots - redshift)))


def read_gadget_snapshot(source, read_pos=True, read_vel=True,
                         read_id=False, read_mass=False, subsample=1.0,
                         seed=42, rng=None, lgadget=False):
    """Read a Gadget-2 format-1 binary snapshot (single file or stream).

    Returns a dict with 'header' plus requested blocks for all particle
    types concatenated. Block layout: header, positions (3 floats per
    particle), velocities, ids, masses. Each block is wrapped in 4-byte
    Fortran record markers.

    Variants handled like the reference reader
    (reference: scripts/parse_snapshot.py:96-140):

    * float64 position/velocity blocks and 8-byte ids are auto-detected
      from the record size (``size == n * items * 8`` selects the wide
      dtype; any other size is an error);
    * a per-particle MASS block follows the ids for every particle type
      whose header ``mass`` entry is zero; ``read_mass=True`` returns a
      per-particle mass array for ALL particles (header-constant types
      filled from the header).  If no type needs the block, header
      masses are broadcast;
    * ``lgadget=True`` applies the L-Gadget header convention: all
      particles are type 1 and ``npart_total[2]`` actually carries the
      high word of the type-1 total count (stored in the header dict as
      ``npart_total_highword``); L-Gadget writes no mass block.
    """
    if rng is None:
        rng = np.random.default_rng(seed)
    out = {}
    own_stream = not hasattr(source, "read")
    stream = open(source, "rb") if own_stream else source
    try:
        def read_block():
            raw = stream.read(4)
            if len(raw) < 4:
                return None
            size = struct.unpack("<I", raw)[0]
            data = stream.read(size)
            end = struct.unpack("<I", stream.read(4))[0]
            if end != size:
                raise IOError("Corrupt Gadget block markers.")
            return data

        def block_dtype(raw, count, items, narrow, wide):
            """Pick the element dtype from the record size (the
            reference's size_check, scripts/parse_snapshot.py:112-117)."""
            if len(raw) == count * items * np.dtype(narrow).itemsize:
                return np.dtype(narrow)
            if len(raw) == count * items * np.dtype(wide).itemsize:
                return np.dtype(wide)
            raise ValueError("Invalid block size in file!")

        # Canonical Gadget-2 header layout: npart[6]u4, mass[6]f8, time f8,
        # redshift f8, flag_sfr/feedback i4 x2, npartTotal[6]u4,
        # flag_cooling/num_files i4 x2, BoxSize f8, Omega0 f8,
        # OmegaLambda f8, HubbleParam f8.
        header_raw = read_block()
        npart = struct.unpack("<6I", header_raw[0:24])
        mass = struct.unpack("<6d", header_raw[24:72])
        time, redshift = struct.unpack("<dd", header_raw[72:88])
        npart_total = list(struct.unpack("<6I", header_raw[96:120]))
        boxsize = struct.unpack("<d", header_raw[128:136])[0]
        omega0, omega_l, hubble = struct.unpack("<ddd",
                                                header_raw[136:160])
        n_total = int(np.sum(npart))
        out["header"] = dict(
            npart=npart, mass=mass, time=time, redshift=redshift,
            boxsize=boxsize, omega0=omega0, omega_lambda=omega_l,
            hubble_param=hubble)
        if lgadget:
            # L-Gadget stores the high word of the type-1 total count in
            # npart_total[2] (reference: scripts/parse_snapshot.py:75-78);
            # it writes no per-particle mass block.
            out["header"]["npart_total_highword"] = npart_total[2]
            npart_total[2] = 0
        out["header"]["npart_total"] = tuple(npart_total)

        keep = (rng.random(n_total) < subsample if subsample < 1.0
                else slice(None))
        # The mass block only exists for types with header mass == 0 and
        # particles present.
        mass_npart = [0 if m else n for m, n in zip(mass, npart)]
        has_mass_block = (not lgadget) and sum(mass_npart) > 0

        # Blocks are strictly sequential (pos, vel, ids, masses): an
        # unread block must still be consumed, else the next read returns
        # the wrong block reinterpreted under the wrong dtype.
        want = dict(pos=read_pos, vel=read_vel, id=read_id,
                    mass=read_mass)
        later = {"pos": ("vel", "id", "mass"), "vel": ("id", "mass"),
                 "id": ("mass",), "mass": ()}

        def handle(name, items, narrow, wide, count=n_total):
            if not (want[name] or any(want[k] for k in later[name])):
                return False  # nothing later either: stop reading
            raw = read_block()
            if want[name]:
                dtype = block_dtype(raw, count, items, narrow, wide)
                data = np.frombuffer(raw, dtype=dtype)
                if items > 1:
                    data = data.reshape(-1, items)
                out[name] = np.array(data[keep])
            return True

        if not handle("pos", 3, "<f4", "<f8"):
            return out
        if not handle("vel", 3, "<f4", "<f8"):
            return out
        if not handle("id", 1, "<u4", "<u8"):
            return out
        if want["mass"]:
            if has_mass_block:
                raw = read_block()
                dtype = block_dtype(raw, sum(mass_npart), 1, "<f4", "<f8")
                block = np.frombuffer(raw, dtype=dtype).astype(np.float64)
                full = np.empty(n_total, np.float64)
                at_block, at_full = 0, 0
                for t in range(6):
                    n_t = npart[t]
                    if mass_npart[t]:
                        full[at_full:at_full + n_t] = \
                            block[at_block:at_block + n_t]
                        at_block += n_t
                    else:
                        full[at_full:at_full + n_t] = mass[t]
                    at_full += n_t
                out["mass"] = full[keep]
            else:
                full = np.repeat(np.asarray(mass, np.float64), npart)
                out["mass"] = full[keep]
    finally:
        if own_stream:
            stream.close()
    return out


def parse_rockstar_ascii(text):
    """Parse a Rockstar ASCII list: commented header line -> column dict."""
    lines = text.splitlines()
    if not lines or not lines[0].startswith("#"):
        raise ValueError("Expected a commented header line.")
    names = lines[0].lstrip("#").split()
    data = np.atleast_2d(np.genfromtxt(io.StringIO(text), comments="#"))
    if data.shape[1] != len(names):
        raise ValueError(
            f"Header names {len(names)} != data columns {data.shape[1]}.")
    return {name.split("(")[0]: data[:, i] for i, name in enumerate(names)}


def read_rockstar_halos(path, mdef="200m"):
    """Read a Rockstar out_*.list ASCII halo catalog into column arrays.

    Raises if the requested mass definition is absent: substituting
    another definition (e.g. Mvir) silently would poison every mass bin
    downstream.
    """
    with open(path) as stream:
        text = stream.read()
    raw = parse_rockstar_ascii(text)
    columns = {name.lower(): name for name in raw}
    if f"m{mdef}" not in columns:
        raise ValueError(
            f"No M{mdef} column in {path}; refusing to substitute another "
            f"mass definition. Available: {sorted(raw)}")
    out = {
        "halo_x": raw[columns["x"]],
        "halo_y": raw[columns["y"]],
        "halo_z": raw[columns["z"]],
        "halo_vx": raw[columns["vx"]],
        "halo_vy": raw[columns["vy"]],
        "halo_vz": raw[columns["vz"]],
        f"halo_m{mdef}": raw[columns[f"m{mdef}"]],
        "halo_rs": raw[columns["rs"]] / 1e3,  # kpc/h -> Mpc/h
    }
    if "rvir" in columns:
        out[f"halo_r{mdef}"] = raw[columns["rvir"]] / 1e3
    if "vmax" in columns:
        out["halo_vmax"] = raw[columns["vmax"]]
    return out


def make_aemulus_fetch(simulation, raw_dir=None):
    """``fetch(relative_path) -> bytes`` for AemulusAlpha products.

    Default transport: basic-auth HTTP against the SLAC server using the
    AEMULUS_USERNAME / AEMULUS_PASSWORD environment variables (reference:
    scripts/parse_snapshot.py:145-150, :163-164).  With ``raw_dir``, reads
    the same relative layout from local disk instead.
    """
    if raw_dir is not None:
        root = Path(raw_dir)

        def fetch(relpath):
            return (root / relpath).read_bytes()
        return fetch

    try:
        import requests
    except ImportError:
        raise RuntimeError("AemulusAlpha download requires 'requests'.")
    try:
        auth = (os.environ["AEMULUS_USERNAME"],
                os.environ["AEMULUS_PASSWORD"])
    except KeyError:
        raise RuntimeError("Set the AEMULUS_USERNAME and AEMULUS_PASSWORD "
                           "environment variables.")
    base = f"{AEMULUS_BASE_URL}/{simulation}"

    def fetch(relpath):
        response = requests.get(f"{base}/{relpath}", auth=auth,
                                timeout=600)
        response.raise_for_status()
        return response.content
    return fetch


def download_aemulus_alpha_halos(simulation, redshift, fetch=None):
    """AemulusAlpha host-halo catalog from the bgc2-based lists.

    Reads ``halos/m200b/outbgc2_{n}.list`` (true M200b/R200b from bgc2)
    and merges ``halo_rs`` row-wise from the matching ``out_{n}.list``
    (Rockstar Rs column, kpc/h), keeping hosts (Parent_ID == -1) only —
    the reference's exact recipe (scripts/parse_snapshot.py:143-185).
    """
    snapnum = aemulus_snapshot_number(redshift)
    if fetch is None:
        fetch = make_aemulus_fetch(simulation)

    bgc2 = parse_rockstar_ascii(
        fetch(f"halos/m200b/outbgc2_{snapnum}.list").decode())
    out_list = np.atleast_2d(np.genfromtxt(io.StringIO(
        fetch(f"halos/m200b/out_{snapnum}.list").decode()), comments="#"))
    if len(out_list) != len(next(iter(bgc2.values()))):
        raise ValueError("outbgc2 and out lists have different row counts; "
                         "cannot merge halo_rs row-wise.")

    halos = {
        # M200b/R200b relabeled m200m/r200m like the reference (:175-176).
        "halo_m200m": bgc2["M200b"],
        "halo_r200m": bgc2["R200b"] / 1e3,       # kpc/h -> Mpc/h (:173)
        "halo_vmax": bgc2["Vmax"],
        "halo_x": bgc2["X"], "halo_y": bgc2["Y"], "halo_z": bgc2["Z"],
        "halo_vx": bgc2["VX"], "halo_vy": bgc2["VY"], "halo_vz": bgc2["VZ"],
        # Rockstar out_*.list column 7 (1-indexed) is Rs [kpc/h] (:169-172).
        "halo_rs": out_list[:, 6] / 1e3,
    }
    hosts = bgc2["Parent_ID"] == -1
    return {key: value[hosts] for key, value in halos.items()}


def download_aemulus_alpha_particles(simulation, redshift, fetch=None,
                                     subsample=0.01, seed=None,
                                     n_chunks=AEMULUS_N_PARTICLE_CHUNKS,
                                     progress=True):
    """AemulusAlpha particle subsample from the Gadget snapshot chunks.

    Fetches all snapshot chunks
    ``output/snapdir_{n:03d}/snapshot_{n:03d}.{chunk}``, keeps a random
    ``subsample`` fraction of the positions from each (reference keeps 1%,
    scripts/parse_snapshot.py:188-222).
    """
    snapnum = aemulus_snapshot_number(redshift)
    if fetch is None:
        fetch = make_aemulus_fetch(simulation)
    rng = np.random.default_rng(seed)

    positions = []
    for chunk in progress_bar(range(n_chunks), desc="particle chunks",
                              disable=not progress):
        relpath = (f"output/snapdir_{snapnum:03d}/"
                   f"snapshot_{snapnum:03d}.{chunk}")
        snap = read_gadget_snapshot(
            io.BytesIO(fetch(relpath)), read_pos=True, read_vel=False,
            subsample=subsample, rng=rng)
        positions.append(snap["pos"])
    positions = np.vstack(positions)
    return {"x": positions[:, 0], "y": positions[:, 1],
            "z": positions[:, 2]}


def abacus_halo_dir(raw_dir, redshift=None):
    """z-specific CompaSO halo directory under a simulation root.

    ``redshift=None`` keeps ``raw_dir`` as-is (back-compat for callers
    that already point at the z-directory).
    """
    halo_dir = Path(raw_dir)
    if redshift is not None:
        halo_dir = halo_dir / "halos" / f"z{redshift:.3f}"
    return halo_dir


def read_abacus_summit_halos(raw_dir, redshift=None, n_min=300):
    """Read an AbacusSummit CompaSO halo catalog (requires abacusutils).

    ``raw_dir`` is the SIMULATION ROOT (the same convention as
    :func:`read_abacus_summit_particles`): the z-specific CompaSO
    directory ``{raw_dir}/halos/z{redshift:.3f}`` is derived internally
    when ``redshift`` is given.  With ``redshift=None``, ``raw_dir``
    must itself be the z-specific halo directory (back-compat).

    Reference recipe (scripts/parse_snapshot.py:225-253): N >= n_min
    particles, mass = N * particle mass under the L1 SO definition, radius
    = r100_L2com, r_s = rvcirc_max_L2com / 2.16258 (the NFW relation),
    positions recentered from [-L/2, L/2) to [0, L) by +BoxSize/2 (the
    same recentering as the particle reader, keeping halo and particle
    coordinates consistent for lensing).
    """
    halo_dir = abacus_halo_dir(raw_dir, redshift)
    try:
        from abacusnbody.data.compaso_halo_catalog import CompaSOHaloCatalog
    except ImportError:
        raise RuntimeError(
            "AbacusSummit ingestion requires the 'abacusutils' package.")
    cat = CompaSOHaloCatalog(
        str(halo_dir),
        fields=["N", "x_L2com", "v_L2com", "r100_L2com",
                "rvcirc_max_L2com"],
        filter_func=lambda h: h["N"] >= n_min)
    halos = cat.halos
    meta = cat.header
    lbox = meta["BoxSize"]
    particle_mass = meta["ParticleMassHMsun"]
    mdef = "{:.0f}m".format(meta["SODensityL1"])
    pos = np.asarray(halos["x_L2com"]) + lbox / 2.0
    out = {
        "halo_x": pos[:, 0], "halo_y": pos[:, 1], "halo_z": pos[:, 2],
        "halo_vx": np.asarray(halos["v_L2com"])[:, 0],
        "halo_vy": np.asarray(halos["v_L2com"])[:, 1],
        "halo_vz": np.asarray(halos["v_L2com"])[:, 2],
        f"halo_m{mdef}": np.asarray(halos["N"]) * particle_mass,
        f"halo_r{mdef}": np.asarray(halos["r100_L2com"]),
        # NFW scale radius from the peak-circular-velocity radius:
        # r_s = r_vmax / 2.16258 (the NFW relation).
        "halo_rs": np.asarray(halos["rvcirc_max_L2com"]) / 2.16258,
    }
    return out, meta


def _default_asdf_reader(path):
    """(N, 3) particle positions from an AbacusSummit rv_A asdf file."""
    try:
        from abacusnbody.data.read_abacus import read_asdf
    except ImportError:
        raise RuntimeError(
            "AbacusSummit particle ingestion requires the 'abacusutils' "
            "package (pass asdf_reader= to inject another reader).")
    return np.asarray(read_asdf(path, load=["pos"])["pos"])


def make_htar_retrieve(simulation,
                       tape_path=ABACUS_SUMMIT_PATH_TAPE):
    """Tape-retrieval hook extracting archived field_rv_A files via htar.

    NERSC-specific (reference: scripts/parse_snapshot.py:260-265): the
    z = 0.3 / 0.4 field A-subsamples live only in the tape archive.
    Returns a callable ``retrieve(member) -> extraction_root``.
    """
    def retrieve(member):
        import tempfile
        archive = (Path(tape_path) / f"AbacusSummit_{simulation}" /
                   f"Abacus_AbacusSummit_{simulation}_halos.tar")
        # Extract into a dedicated temporary directory: extracting into
        # the cwd would make the post-read cleanup remove a './halos'
        # tree the user may own.  tempfile honors $TMPDIR — point it at
        # scratch on nodes whose /tmp is a small tmpfs (extractions can
        # be tens of GB).
        dest = Path(tempfile.mkdtemp(prefix="tabcorr_htar_"))
        subprocess.run(["htar", "-x", "-f", str(archive), f"./{member}"],
                       check=True, cwd=dest)
        return dest
    return retrieve


def read_abacus_par_boxsize(path):
    """BoxSize from an AbacusSummit info/abacus.par parameter file."""
    with open(path) as stream:
        for line in stream:
            key, _, value = line.partition("=")
            if key.strip() == "BoxSize":
                return float(value.split("#")[0])
    raise ValueError(f"No BoxSize entry in {path}.")


def read_abacus_summit_particles(raw_dir, redshift, simulation=None,
                                 fraction=ABACUS_PARTICLE_FRACTION,
                                 asdf_reader=None, tape_retrieve=None,
                                 n_chunks=ABACUS_N_PARTICLE_CHUNKS,
                                 seed=None, boxsize=None, progress=True):
    """AbacusSummit particle subsample from the rv_A asdf chunks.

    Reads the ``field`` and ``halo`` A-subsample files under
    ``{raw_dir}/halos/z{z:.3f}/{type}_rv_A/``, thins each chunk to
    ``fraction`` of ALL simulation particles (i.e. fraction/0.03 of the 3%
    A subsample), and recenters by +BoxSize/2 (read from info/abacus.par
    unless ``boxsize`` is given).  For the redshifts whose field files are
    tape-archived (z = 0.3/0.4), ``tape_retrieve(member) -> root`` is
    called first (see :func:`make_htar_retrieve`).
    Reference: scripts/parse_snapshot.py:256-290.
    """
    rng = np.random.default_rng(seed)
    if asdf_reader is None:
        asdf_reader = _default_asdf_reader
    raw_dir = Path(raw_dir)
    thin = fraction / ABACUS_A_SUBSAMPLE
    retrieved_root = None

    positions = []
    for ptcl_type in ("field", "halo"):
        base = raw_dir
        local_subdir = (raw_dir / "halos" / f"z{redshift:.3f}" /
                        f"{ptcl_type}_rv_A")
        if (ptcl_type == "field" and
                np.any(np.isclose(redshift, [0.3, 0.4])) and
                not local_subdir.is_dir()):
            # Tape only when the files are not already on disk.
            if tape_retrieve is None:
                if simulation is None:
                    raise RuntimeError(
                        "field_rv_A for z=0.3/0.4 is tape-archived; pass "
                        "tape_retrieve= (or simulation= for the default "
                        "htar hook).")
                tape_retrieve = make_htar_retrieve(simulation)
            member = f"halos/z{redshift:.3f}/field_rv_A"
            base = Path(tape_retrieve(member))
            retrieved_root = base
        subdir = base / "halos" / f"z{redshift:.3f}" / f"{ptcl_type}_rv_A"
        for i in progress_bar(range(n_chunks), desc=f"{ptcl_type} chunks",
                              disable=not progress):
            pos = np.asarray(
                asdf_reader(subdir / f"{ptcl_type}_rv_A_{i:03d}.asdf"))
            positions.append(pos[rng.random(len(pos)) < thin])

    positions = np.vstack(positions)
    if retrieved_root is not None and retrieved_root != raw_dir:
        # Remove the tape hook's dedicated extraction root entirely.
        import shutil
        shutil.rmtree(retrieved_root, ignore_errors=True)

    if boxsize is None:
        boxsize = read_abacus_par_boxsize(raw_dir / "info" / "abacus.par")
    positions = positions + boxsize / 2.0
    return {"x": positions[:, 0], "y": positions[:, 1],
            "z": positions[:, 2]}


def _json_value(value):
    """A metadata value as a JSON value (numpy scalars and arrays too)."""
    if isinstance(value, bytes):
        return value.decode("utf-8")
    if isinstance(value, (np.generic, np.ndarray)):
        return value.tolist()
    return value


def append_snapshot_table(path, name, table, attrs=None):
    """Write/overwrite one table in the snapshot, keeping the others: in
    the reference's HDF5 (a structured dataset, the metadata as its
    attributes) for a ``.hdf5`` path, else in the ``.npz`` form (the
    structured array ``name``, the metadata as JSON under
    ``name + ".attrs"``)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = ColumnTable({k: np.asarray(v) for k, v in table.items()})
    if path.suffix == ".npz":
        arrays = {}
        if path.exists():
            with np.load(path, allow_pickle=False) as old:
                arrays = {k: old[k] for k in old.files
                          if k not in (name, name + ".attrs")}
        arrays[name] = data.as_structured_array()
        arrays[name + ".attrs"] = np.array(json.dumps(
            {k: _json_value(v) for k, v in (attrs or {}).items()}))
        tmp = path.with_name(path.name + ".tmp.npz")
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
        return
    import h5py

    with h5py.File(path, "a") as fstream:
        if name in fstream:
            del fstream[name]
        fstream[name] = data.as_structured_array()
        for key, value in (attrs or {}).items():
            fstream[name].attrs[key] = value


def read_snapshot_table(path, name):
    """(table as a structured array, metadata dict) of one table of the
    snapshot, from either form (what ``torch_tabulate_snapshot.py``
    reads); (None, None) where it has no such table."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path, allow_pickle=False) as data:
            if name not in data.files:
                return None, None
            return data[name], json.loads(str(data[name + ".attrs"]))
    import h5py

    with h5py.File(path, "r") as fstream:
        if name not in fstream:
            return None, None
        return fstream[name][()], dict(fstream[name].attrs)


def write_snapshot(path, halos, meta, particles=None):
    """Write the database's snapshot (tables 'halos'/'particles'):
    ``snapshot.hdf5`` or ``snapshot.npz``, by the suffix of ``path``."""
    append_snapshot_table(path, "halos", halos, attrs=meta)
    if particles is not None:
        append_snapshot_table(path, "particles", particles)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Download/read and reduce an AemulusAlpha or "
                    "AbacusSummit simulation into the database.")
    parser.add_argument("suite", choices=["AemulusAlpha", "AbacusSummit"])
    parser.add_argument("redshift", type=float)
    parser.add_argument("--cosmo", type=int, default=0,
                        help="simulation cosmology, default is 0")
    parser.add_argument("--phase", type=int, default=0,
                        help="simulation phase, default is 0")
    parser.add_argument("--config", default=None,
                        help="simulation configuration to assume")
    parser.add_argument("--particles", action="store_true",
                        help="ingest the particle subsample instead of "
                             "halos")
    parser.add_argument("--raw_dir", default=None,
                        help="local directory with the raw simulation "
                             "products (skips any download; required for "
                             "AbacusSummit, where it is the SIMULATION "
                             "ROOT for halos and particles alike)")
    parser.add_argument("--subsample", type=float, default=None,
                        help="particle subsample fraction (default: 0.01 "
                             "of all particles for AemulusAlpha, 0.00025 "
                             "for AbacusSummit)")
    parser.add_argument("--format", choices=database.FORMATS,
                        default="hdf5",
                        help="snapshot file: the reference's snapshot.hdf5 "
                             "(default; needs h5py) or snapshot.npz")
    args = parser.parse_args(argv)

    name = database.simulation_name(
        args.suite, i_cosmo=args.cosmo, i_phase=args.phase,
        config=args.config)
    print(f"Parsing data for {name} at z={args.redshift:.2f}...")
    out_path = database.directory(
        args.suite, args.redshift, i_cosmo=args.cosmo,
        i_phase=args.phase, config=args.config) / f"snapshot.{args.format}"

    if args.suite == "AemulusAlpha":
        fetch = make_aemulus_fetch(name, raw_dir=args.raw_dir)
        if args.particles:
            table = download_aemulus_alpha_particles(
                name, args.redshift, fetch=fetch,
                subsample=(0.01 if args.subsample is None
                           else args.subsample))
            append_snapshot_table(out_path, "particles", table)
        else:
            table = download_aemulus_alpha_halos(name, args.redshift,
                                                 fetch=fetch)
            append_snapshot_table(out_path, "halos", table,
                                  attrs={"BoxSize": 1050.0})
    else:
        if args.raw_dir is None:
            raise RuntimeError(
                "AbacusSummit ingestion reads local CompaSO products; "
                "pass --raw_dir (the SIMULATION ROOT, e.g. "
                ".../AbacusSummit_base_c000_ph000 — the z-specific "
                "subdirectories are derived internally for halos and "
                "particles alike).")
        if args.particles:
            table = read_abacus_summit_particles(
                args.raw_dir, args.redshift, simulation=name,
                fraction=(ABACUS_PARTICLE_FRACTION
                          if args.subsample is None
                          else args.subsample))
            append_snapshot_table(out_path, "particles", table)
        else:
            halos, meta = read_abacus_summit_halos(args.raw_dir,
                                                   redshift=args.redshift)
            append_snapshot_table(out_path, "halos", halos, attrs=meta)

    print(f"Wrote {out_path}")


if __name__ == "__main__":
    main()
