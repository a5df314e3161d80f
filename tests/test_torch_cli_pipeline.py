"""Both production CLIs on one small snapshot: ``scripts/
tabulate_snapshot.py`` (tabcorr_tpu) and ``scripts/
torch_tabulate_snapshot.py`` (the port, ``--device cpu``), for wp, Delta
Sigma and xi, each from a parsed AbacusSummit-layout snapshot of 3,000
hosts to the assembled Interpolator file.

The configuration registry is patched in both script modules down to 4
nodes on log_eta (the spline needs 4 an axis; alpha_c and alpha_s
constant, so both are dropped).  tabcorr_tpu counts on its XLA sweep (its
C++ counter switched off), in float32 geometry as the port's plain
version does, so the Interpolators agree as test_torch_tabulate.py holds
tables: 1e-9, and the annulus-mean Delta Sigma at 5e-5 of the table's
largest entry (tabcorr_tpu sums its ln(rp) channel in float32).  Then
``--format npz`` against ``--format hdf5`` (equal), and ``--resume``.
"""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).absolute().parent.parent / "scripts"))

import tabulate_snapshot  # noqa: E402
import torch_parse_snapshot  # noqa: E402
import torch_tabulate_snapshot  # noqa: E402

import tabcorr_tpu as tt  # noqa: E402
import tabcorr_tpu.ops.paircount as jpc  # noqa: E402
import tabcorr_tpu_torch as tp  # noqa: E402

N_HALOS = 3000
LBOX = 2000.0          # AbacusSummit's box [Mpc/h]
META = {"BoxSize": LBOX, "SODensityL1": 200.0, "ParticleMassHMsun": 1e10,
        "ppd": 6912}
ETA_NODES = np.geomspace(1.0 / 3.0, 3.0, 4)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """snapshot.hdf5 and snapshot.npz of one catalog: masses evenly spaced
    in log over 0.3 dex above the 299-particle cut, so that each of the
    Delta Sigma tables' 300 x 2 cells holds ~5 hosts and draws ~16
    satellites at the 'efficient' 1e-13 per Msun/h; the concentration
    split alternating so each mass has both percentiles; 3,000
    particles."""
    rng = np.random.default_rng(11)
    mass = 10.0 ** (13.35 + 0.3 * (np.arange(N_HALOS) + 0.5) / N_HALOS)
    mass[:20], mass[-20:] = mass[0], mass[-1]
    r200 = 1.2 * (mass / 1e14) ** (1 / 3)
    halos = {
        "halo_x": rng.uniform(0, LBOX, N_HALOS),
        "halo_y": rng.uniform(0, LBOX, N_HALOS),
        "halo_z": rng.uniform(0, LBOX, N_HALOS),
        "halo_vx": 300 * rng.normal(size=N_HALOS),
        "halo_vy": 300 * rng.normal(size=N_HALOS),
        "halo_vz": 300 * rng.normal(size=N_HALOS),
        "halo_m200m": mass, "halo_r200m": r200,
        "halo_rs": r200 / np.where(np.arange(N_HALOS) % 2, 4.0, 9.0),
    }
    ptcls = {k: rng.uniform(0, LBOX, 3000) for k in "xyz"}
    root = tmp_path_factory.mktemp("snapshot")
    for fmt in ("hdf5", "npz"):
        torch_parse_snapshot.write_snapshot(root / f"snapshot.{fmt}", halos,
                                            META, particles=ptcls)
    return root


def _database(tmp_path, monkeypatch, snapshot, name):
    """A database root holding the snapshot, as TABCORR_DATABASE."""
    monkeypatch.setenv("TABCORR_DATABASE", str(tmp_path / name))
    target = tp.database.directory("AbacusSummit", 0.5)
    target.mkdir(parents=True, exist_ok=True)
    for fmt in ("hdf5", "npz"):
        shutil.copy(snapshot / f"snapshot.{fmt}", target)
    return target


@pytest.fixture
def small_grids(monkeypatch):
    """Both script modules' configuration registries, cut to 4 nodes."""
    monkeypatch.setattr(jpc, "_native_eligible", lambda *a: False)
    for module in (tabulate_snapshot, torch_tabulate_snapshot):
        real = module.database.configuration

        def configuration(config_str, real=real):
            config = real(config_str)
            config.update(alpha_c_bins=[0.0], alpha_s_bins=[1.0],
                          conc_gal_bias_bins=ETA_NODES)
            return config

        monkeypatch.setattr(module.database, "configuration",
                            configuration)


ARGS = ["AbacusSummit", "0.5", "--tab_config", "efficient", "--seed", "1"]
STATISTICS = {"wp": ["wp"], "ds": ["ds"], "xi": ["xi0", "xi2", "xi4"]}


def _run_both(tpcf, tmp_path, monkeypatch, snapshot):
    """(tabcorr_tpu's, the port's) directory after each CLI's run."""
    dirs = []
    for name, module, extra in (
            ("jax", tabulate_snapshot, []),
            ("port", torch_tabulate_snapshot, ["--device", "cpu"])):
        dirs.append(_database(tmp_path, monkeypatch, snapshot, name))
        monkeypatch.setattr(sys, "argv", ["cli", *ARGS, "--tpcf", tpcf,
                                          *extra])
        module.main()
    return dirs


def _assert_same_interpolator(a, b, rtol, scaled_atol=0.0):
    assert b.keys == a.keys == ["log_eta"]
    np.testing.assert_allclose(b.param_dict_table["log_eta"],
                               a.param_dict_table["log_eta"], rtol=1e-15)
    for ta, tb in zip(a.tabcorr_list, b.tabcorr_list):
        assert tb.attrs == ta.attrs
        for col in ta.gal_type.colnames:
            np.testing.assert_array_equal(tb.gal_type[col], ta.gal_type[col])
        assert tuple(tb.tpcf_shape) == tuple(ta.tpcf_shape)
        for x, y in zip(ta.tpcf_args, tb.tpcf_args):
            np.testing.assert_array_equal(y, x)
        np.testing.assert_allclose(
            tb.tpcf_matrix, ta.tpcf_matrix, rtol=rtol,
            atol=scaled_atol * np.abs(ta.tpcf_matrix).max())


@pytest.mark.parametrize("tpcf", list(STATISTICS))
def test_cli_interpolators_match(tpcf, tmp_path, monkeypatch, snapshot,
                                 small_grids):
    jax_dir, port_dir = _run_both(tpcf, tmp_path, monkeypatch, snapshot)
    assert ((port_dir / "efficient" / f"{tpcf}_grid.csv").read_text() ==
            (jax_dir / "efficient" / f"{tpcf}_grid.csv").read_text())
    for stat in STATISTICS[tpcf]:
        ref = tt.Interpolator.read(jax_dir / f"{stat}_efficient.hdf5")
        port = tp.Interpolator.read(port_dir / f"{stat}_efficient.hdf5")
        if tpcf == "ds":
            # 300 mass bins x 2 percentiles x 2 galaxy types, cross mode,
            # less the empty cells; the particle positions are an
            # argument the file drops only above 10^6 elements (here
            # 9,000: kept).
            assert 1100 < port.tabcorr_list[0].n_bins <= 1200
            assert port.tabcorr_list[0].tpcf_args[0].shape == (3000, 3)
            _assert_same_interpolator(ref, port, rtol=0, scaled_atol=5e-5)
        else:
            _assert_same_interpolator(ref, port, rtol=1e-9)
        # The port's own reader takes tabcorr_tpu's file alike.
        _assert_same_interpolator(ref, tp.Interpolator.read(
            jax_dir / f"{stat}_efficient.hdf5"), rtol=0)
    # The published layout reads back through the port's database.
    got = tp.database.read("AbacusSummit", 0.5, STATISTICS[tpcf][0],
                           tab_config="efficient")
    assert len(got.tabcorr_list) == 4
    model = tp.Zheng07Model(threshold=-21, redshift=0.5,
                            prim_haloprop_key="halo_m200m", logMmin=13.2,
                            logM0=13.0, logM1=14.0)
    model.param_dict["log_eta"] = 0.1
    ngal, xi = got.predict(model, check_consistency=False)
    assert ngal > 0 and np.all(np.isfinite(xi))


def test_npz_format_equals_hdf5_and_resume(tmp_path, monkeypatch, snapshot,
                                           small_grids, capsys):
    port_dir = _database(tmp_path, monkeypatch, snapshot, "port")
    base = [*ARGS, "--tpcf", "wp", "--device", "cpu"]
    torch_tabulate_snapshot.main(base)
    torch_tabulate_snapshot.main([*base, "--format", "npz"])
    hdf5 = tp.database.read("AbacusSummit", 0.5, "wp",
                            tab_config="efficient")
    npz = tp.database.read("AbacusSummit", 0.5, "wp",
                           tab_config="efficient", format="npz")
    _assert_same_interpolator(hdf5, npz, rtol=0)
    for i in range(4):
        assert (port_dir / "efficient" / f"wp_{i}.npz").exists()
    # --resume retabulates only the node whose file is missing.
    (port_dir / "efficient" / "wp_2.npz").unlink()
    capsys.readouterr()
    torch_tabulate_snapshot.main([*base, "--format", "npz", "--resume"])
    out = capsys.readouterr().out
    assert [f"Skipping grid node {i} (files exist)." for i in (0, 1, 3)] \
        == [line for line in out.splitlines() if line.startswith("Skip")]
    _assert_same_interpolator(npz, tp.database.read(
        "AbacusSummit", 0.5, "wp", tab_config="efficient", format="npz"),
        rtol=0)
    # No device is picked for the caller: without a card, cuda raises.
    if not tp.utils.device.torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            torch_tabulate_snapshot.main([*ARGS, "--tpcf", "wp", "--format",
                                          "npz"])
