"""The port's snapshot scripts (``scripts/torch_parse_snapshot.py``,
``scripts/torch_tabulate_snapshot.py``) against the JAX package's
(``scripts/parse_snapshot.py``, ``scripts/tabulate_snapshot.py``):
tests/test_scripts.py's Gadget, Rockstar and snapshot cases run through
both, and the ``.npz`` snapshot round trip.  Nothing downloads.
"""

import struct
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).absolute().parent.parent / "scripts"))

import parse_snapshot  # noqa: E402
import tabulate_snapshot  # noqa: E402
import torch_parse_snapshot  # noqa: E402
import torch_tabulate_snapshot  # noqa: E402

import tabcorr_tpu as tt  # noqa: E402
import tabcorr_tpu_torch as tp  # noqa: E402

PARSERS = [parse_snapshot, torch_parse_snapshot]


def _write_fake_gadget(path, pos, vel, boxsize=100.0, redshift=0.5):
    """tests/test_scripts.py's format-1 Gadget file."""
    n = len(pos)

    def block(data):
        return struct.pack("<I", len(data)) + data + \
            struct.pack("<I", len(data))

    header = struct.pack("<6I", 0, n, 0, 0, 0, 0)
    header += struct.pack("<6d", 0, 1e9, 0, 0, 0, 0)
    header += struct.pack("<dd", 1.0 / (1 + redshift), redshift)
    header += struct.pack("<ii", 0, 0)
    header += struct.pack("<6I", 0, n, 0, 0, 0, 0)
    header += struct.pack("<ii", 0, 1)
    header += struct.pack("<dddd", boxsize, 0.3, 0.7, 0.7)
    header = header.ljust(256, b"\0")
    with open(path, "wb") as stream:
        stream.write(block(header))
        stream.write(block(pos.astype("<f4").tobytes()))
        stream.write(block(vel.astype("<f4").tobytes()))


def test_gadget_reader_matches(tmp_path):
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 100, (500, 3)).astype(np.float32)
    vel = rng.normal(size=(500, 3)).astype(np.float32)
    path = tmp_path / "snap.gadget"
    _write_fake_gadget(path, pos, vel)
    full = [m.read_gadget_snapshot(path) for m in PARSERS]
    sub = [m.read_gadget_snapshot(path, subsample=0.5) for m in PARSERS]
    for a, b in (full, sub):
        assert b["header"] == a["header"]
        for key in ("pos", "vel"):
            np.testing.assert_array_equal(b[key], a[key])
    assert full[1]["header"]["boxsize"] == 100.0
    np.testing.assert_allclose(full[1]["pos"], pos, rtol=1e-6)
    assert 100 < len(sub[1]["pos"]) < 400


def test_rockstar_reader_matches(tmp_path):
    path = tmp_path / "out_0.8000.list"
    header = "#ID DescID M200m Vmax Vrms Rvir Rs Np X Y Z VX VY VZ\n"
    rows = ["%d 0 %e %f 100 %f %f 500 %f %f %f %f %f %f\n" % (
        i, 1e13 * (1 + i), 200 + i, 250.0, 40.0, 10.0 + i, 20.0, 30.0,
        100.0, -50.0, 25.0) for i in range(5)]
    path.write_text(header + "".join(rows))
    ref, port = (m.read_rockstar_halos(path) for m in PARSERS)
    assert port.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(port[key], ref[key])
    np.testing.assert_allclose(port["halo_rs"], 0.04)
    with pytest.raises(ValueError, match="M500c"):
        torch_parse_snapshot.read_rockstar_halos(path, mdef="500c")


def _halos(n, rng, mdef="200m", lbox=1050.0):
    return {
        "halo_x": rng.uniform(0, lbox, n),
        "halo_y": rng.uniform(0, lbox, n),
        "halo_z": rng.uniform(0, lbox, n),
        "halo_vx": rng.normal(size=n), "halo_vy": rng.normal(size=n),
        "halo_vz": rng.normal(size=n),
        f"halo_m{mdef}": 10 ** rng.uniform(13, 14.5, n),
        f"halo_r{mdef}": rng.uniform(0.3, 1.5, n),
        "halo_rs": rng.uniform(0.05, 0.3, n),
        "halo_vmax": rng.uniform(200, 800, n),
    }


def _assert_same_catalog(a, b):
    assert a.halo_table.colnames == b.halo_table.colnames
    for col in a.halo_table.colnames:
        np.testing.assert_array_equal(b.halo_table[col], a.halo_table[col])
    np.testing.assert_array_equal(b.Lbox, a.Lbox)
    assert (b.particle_mass, b.redshift, b.simname, b.n_ptcls) == (
        a.particle_mass, a.redshift, a.simname, a.n_ptcls)
    assert b.cosmology.H0 == a.cosmology.H0
    assert b.cosmology.Om0 == a.cosmology.Om0
    assert b.cosmology.sigma8 == a.cosmology.sigma8
    assert (a.ptcl_catalog is None) == (b.ptcl_catalog is None)
    if a.ptcl_catalog is not None:
        np.testing.assert_array_equal(b.ptcl_catalog.positions,
                                      a.ptcl_catalog.positions)
        assert (b.ptcl_catalog.effective_particle_mass ==
                a.ptcl_catalog.effective_particle_mass)


def test_snapshot_write_and_read_match(tmp_path, monkeypatch):
    # tests/test_scripts.py's AemulusAlpha snapshot, written by either
    # package's script and read by both tabulation scripts.
    monkeypatch.setenv("TABCORR_DATABASE", str(tmp_path))
    halos = _halos(300, np.random.default_rng(1))
    out_path = (tp.database.directory("AemulusAlpha", 0.25, i_cosmo=0) /
                "snapshot.hdf5")
    assert out_path == (tt.database.directory("AemulusAlpha", 0.25,
                                              i_cosmo=0) / "snapshot.hdf5")
    cats = []
    for writer in PARSERS:
        writer.write_snapshot(out_path, halos, {"BoxSize": 1050.0})
        cats.append(tabulate_snapshot.read_simulation_snapshot(
            "AemulusAlpha", 0.25, i_cosmo=0))
        cats.append(torch_tabulate_snapshot.read_simulation_snapshot(
            "AemulusAlpha", 0.25, i_cosmo=0))
    for cat in cats[1:]:
        _assert_same_catalog(cats[0], cat)
    assert len(cats[1].halo_table) == 300 and cats[1].Lbox[0] == 1050
    np.testing.assert_allclose(cats[1].halo_table["halo_nfw_conc"],
                               halos["halo_r200m"] / halos["halo_rs"])


def test_npz_snapshot_round_trip(tmp_path, monkeypatch):
    # AbacusSummit layout with particles: snapshot.npz reads back as the
    # reference's snapshot.hdf5 does, table by table (appending the
    # particles keeps the halos, rewriting the halos keeps the particles).
    monkeypatch.setenv("TABCORR_DATABASE", str(tmp_path))
    rng = np.random.default_rng(2)
    halos = _halos(400, rng, mdef="200m", lbox=500.0)
    ptcls = {k: rng.uniform(0, 500.0, 2000) for k in "xyz"}
    meta = {"BoxSize": 500.0, "SODensityL1": np.float64(200.0),
            "ParticleMassHMsun": np.float64(2.1e9), "ppd": np.int64(1728),
            "Redshift": 0.5}
    base = tp.database.directory("AbacusSummit", 0.5)
    torch_parse_snapshot.write_snapshot(base / "snapshot.hdf5", halos, meta,
                                        particles=ptcls)
    torch_parse_snapshot.append_snapshot_table(base / "snapshot.npz",
                                               "particles", ptcls)
    torch_parse_snapshot.append_snapshot_table(base / "snapshot.npz",
                                               "halos", halos, attrs=meta)
    for name in ("halos", "particles"):
        a, meta_a = torch_parse_snapshot.read_snapshot_table(
            base / "snapshot.hdf5", name)
        b, meta_b = torch_parse_snapshot.read_snapshot_table(
            base / "snapshot.npz", name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
        assert meta_b == {k: v for k, v in meta_a.items()}
    assert torch_parse_snapshot.read_snapshot_table(
        base / "snapshot.npz", "missing") == (None, None)
    ref = tabulate_snapshot.read_simulation_snapshot("AbacusSummit", 0.5)
    hdf5 = torch_tabulate_snapshot.read_simulation_snapshot("AbacusSummit",
                                                            0.5)
    npz = torch_tabulate_snapshot.read_simulation_snapshot(
        "AbacusSummit", 0.5, format="npz")
    _assert_same_catalog(ref, hdf5)
    _assert_same_catalog(ref, npz)
    assert npz.particle_mass == 2.1e9 and npz.n_ptcls == 1728 ** 3
    assert "halo_m200m" in npz.halo_table.colnames
    with pytest.raises(ValueError, match="format"):
        torch_tabulate_snapshot.read_simulation_snapshot(
            "AbacusSummit", 0.5, format="fits")
    with pytest.raises(ValueError, match="format"):
        tp.database.read("AbacusSummit", 0.5, "wp", format="fits")


def test_parse_main_writes_either_format(tmp_path, monkeypatch):
    # main() on local Aemulus products (the fetch hook reads --raw_dir):
    # the bgc2 list and the out list of snapshot 7 (z = 0.25).
    monkeypatch.setenv("TABCORR_DATABASE", str(tmp_path / "db"))
    raw = tmp_path / "raw" / "halos" / "m200b"
    raw.mkdir(parents=True)
    names = ("ID DescID M200b Vmax Vrms R200b Rs Np X Y Z VX VY VZ JX JY JZ "
             "Spin Parent_ID")
    rows = ["%d -1 %e 300 100 800 50 500 %f %f %f 1 2 3 0 0 0 0.1 %d" % (
        i, 1e13 * (i + 1), 10.0 * i, 20.0, 30.0, -1 if i % 3 else 0)
        for i in range(6)]
    (raw / "outbgc2_7.list").write_text("#" + names + "\n" +
                                        "\n".join(rows) + "\n")
    (raw / "out_7.list").write_text(
        "#ID DescID Mvir Vmax Vrms Rvir Rs\n" + "\n".join(
            "%d -1 1e13 300 100 800 %f" % (i, 40.0 + i)
            for i in range(6)) + "\n")
    out = {}
    for fmt in ("hdf5", "npz"):
        torch_parse_snapshot.main(["AemulusAlpha", "0.25", "--raw_dir",
                                   str(tmp_path / "raw"), "--format", fmt])
        path = (tp.database.directory("AemulusAlpha", 0.25) /
                f"snapshot.{fmt}")
        out[fmt] = torch_parse_snapshot.read_snapshot_table(path, "halos")
    np.testing.assert_array_equal(out["npz"][0], out["hdf5"][0])
    assert out["npz"][1] == {"BoxSize": 1050.0}
    assert len(out["npz"][0]) == 4       # the hosts (Parent_ID == -1)
    np.testing.assert_allclose(out["npz"][0]["halo_rs"],
                               [0.041, 0.042, 0.044, 0.045])
