"""Lightcurve loader tests over synthetic files (Simple CSV, Swift QDP,
Fermi CSV) and the legacy readingutils parsers."""
import numpy as np
import pytest

from mind_the_gaps_tpu import FermiLightcurve, GappyLightcurve, SimpleLightcurve, SwiftLightcurve
from mind_the_gaps_tpu import readingutils


def test_simple_lightcurve_seconds(tmp_path):
    f = tmp_path / "lc.csv"
    f.write_text(
        "t\trate\terror\texposure\tbkg_rate\tbkg_rate_err\n"
        + "\n".join(
            f"{10.0*i:.1f}\t{1.0+0.1*i:.3f}\t0.05\t2.0\t0.01\t0.001" for i in range(20)
        )
    )
    lc = SimpleLightcurve(str(f))
    assert lc.n == 20
    np.testing.assert_allclose(lc.times, 10.0 * np.arange(20))
    np.testing.assert_allclose(lc.exposures, 2.0)
    np.testing.assert_allclose(lc.bkg_rate, 0.01)


def test_simple_lightcurve_days_converted(tmp_path):
    f = tmp_path / "lc.csv"
    f.write_text(
        "mjd rate error\n" + "\n".join(f"{50000 + i} {1.0} {0.1}" for i in range(5))
    )
    with pytest.warns(UserWarning):
        lc = SimpleLightcurve(str(f))
    np.testing.assert_allclose(np.diff(lc.times), 86400.0)


def test_roundtrip_to_csv(tmp_path):
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(5, 10, 30))
    lc = GappyLightcurve(t, rng.normal(5, 1, 30), np.full(30, 0.3), exposures=2.0)
    out = tmp_path / "out.dat"
    lc.to_csv(str(out))
    t2, r2, e2, exp2, bkg2, bkgerr2 = readingutils.read_standard_lightcurve(str(out))
    np.testing.assert_allclose(t2, lc.times, rtol=1e-7)
    np.testing.assert_allclose(r2, lc.y, atol=1e-4)
    np.testing.assert_allclose(exp2, 2.0)


def _write_pccurve(path, n=10):
    header = (
        "READ TERR 1 2\n!MJD\n"
        "MJD\tT_+ve\tT_-ve\tRate\tRatepos\tRateneg\tSNR\tBGrate\tBGerr\t"
        "CorrFact\tCtsInSrc\tBGInSrc\tExposure\tSigma\tSNR2\tObsID\n"
    )
    rows = []
    for i in range(n):
        rows.append(
            f"{50000 + 2*i}\t0.5\t-0.5\t{1.0 + 0.05*i:.4f}\t0.1\t-0.1\t10.0\t0.01\t0.001\t"
            f"1.1\t{100+i}\t5.0\t1000.0\t8.0\t10.0\t000{i}"
        )
    path.write_text(header + "\n".join(rows))


def test_swift_lightcurve(tmp_path):
    f = tmp_path / "PCCURVE.qdp"
    _write_pccurve(f)
    lc = SwiftLightcurve(str(f))
    assert lc.n == 10
    # MJD -> seconds
    np.testing.assert_allclose(np.diff(lc.times), 2 * 86400.0)
    # exposure corrected by CorrFact
    np.testing.assert_allclose(lc.exposures, 1000.0 / 1.1)
    # background rescaled by CorrFact
    np.testing.assert_allclose(lc.bkg_rate, 0.01 * 1.1)
    # symmetric error from the +/- columns
    np.testing.assert_allclose(lc.dy, 0.1)


def test_swift_filtering(tmp_path):
    f = tmp_path / "PCCURVE.qdp"
    _write_pccurve(f)
    lc = SwiftLightcurve(str(f), minCts=105)
    assert lc.n == 5  # CtsInSrc = 100..109, >= 105 keeps 5


def test_fermi_lightcurve(tmp_path):
    f = tmp_path / "fermi.csv"
    f.write_text(
        "mjd,flux,flux_err_neg,flux_err_pos\n"
        + "\n".join(f"{55000+i},{2.0+0.1*i},-0.2,0.4" for i in range(8))
    )
    lc = FermiLightcurve(str(f))
    assert lc.n == 8
    np.testing.assert_allclose(lc.dy, 0.3)  # (|neg| + pos)/2
    np.testing.assert_allclose(np.diff(lc.times), 86400.0)


def test_readPCCURVE_legacy(tmp_path):
    f = tmp_path / "PCCURVE.qdp"
    _write_pccurve(f)
    data = readingutils.readPCCURVE(str(f))
    assert len(data) == 10
    data = readingutils.readPCCURVE(str(f), minCts=108)
    assert len(data) == 2


def test_split_and_rand_remove():
    t = np.concatenate([np.arange(10.0), 100 + np.arange(10.0)])
    lc = GappyLightcurve(t, np.ones(20), np.full(20, 0.1))
    parts = lc.split(interval=50.0)
    assert len(parts) == 2
    assert parts[0].n == 10

    smaller = lc.rand_remove(5, rng=np.random.default_rng(0))
    assert smaller.n == 15


# ------------------------------------------------------------------ #
# native fastio parser (C extension with numpy fallback)
# ------------------------------------------------------------------ #
def test_fastio_parse_qdp_and_csv(tmp_path):
    from mind_the_gaps_tpu.io import load_columns, load_table
    from mind_the_gaps_tpu.io.fastio import _parse_numpy

    qdp = (
        b"! Swift-XRT data\nREAD TERR 1 2\n"
        b"!Time Tpos Tneg Rate Ratepos Rateneg\n"
        b"110.0 5.0 -5.0 0.31 0.02 -0.02\n"
        b"130.0 5.0 -5.0 NO 0.03 -0.03\n"
        b"150.0 5.0 -5.0 0.29 0.02 -0.02\n"
    )
    p = tmp_path / "a.qdp"
    p.write_bytes(qdp)
    arr = load_table(str(p))
    assert arr.shape == (3, 6)
    assert np.isnan(arr[1, 3]) and arr[2, 0] == 150.0
    # the C parser and the numpy fallback must agree exactly
    ref, _ = _parse_numpy(qdp)
    np.testing.assert_array_equal(np.nan_to_num(arr, nan=-1), np.nan_to_num(ref, nan=-1))

    c = tmp_path / "b.csv"
    c.write_text("mjd,rate,error\n55000.5,1.2,0.1\n55001.5,1.3,0.1\n")
    cols = load_columns(str(c))
    assert list(cols) == ["mjd", "rate", "error"]
    assert cols["rate"][1] == 1.3


def test_fastio_bulk_directory(tmp_path):
    from mind_the_gaps_tpu.lightcurves import SimpleLightcurve
    from mind_the_gaps_tpu.lightcurves.loaders import load_lightcurve_directory

    rng = np.random.default_rng(3)
    paths = []
    for i in range(6):
        t = np.cumsum(rng.uniform(1, 3, 40))
        body = "time rate error exposure\n" + "\n".join(
            f"{ti} {ri} 0.1 0.5" for ti, ri in zip(t, rng.normal(5, 1, 40))
        )
        p = tmp_path / f"lc{i}.dat"
        p.write_text(body)
        paths.append(str(p))
    lcs = load_lightcurve_directory(paths, workers=4)
    assert len(lcs) == 6
    one = SimpleLightcurve(paths[0])
    np.testing.assert_allclose(lcs[0].times, one.times)
    np.testing.assert_allclose(lcs[0].y, one.y)
    np.testing.assert_allclose(lcs[0].exposures, one.exposures)


# ------------------------------------------------------------------ #
# remaining legacy readingutils functions
# ------------------------------------------------------------------ #
def test_read_data_filters_and_units(tmp_path):
    f = tmp_path / "PCCURVE.qdp"
    _write_pccurve(f)
    t, y, yerr, exp, bkg_counts, bkg_err = readingutils.read_data(str(f), tmin=50004, tmax=50010)
    assert len(t) == 4  # MJD 50004..50010 step 2
    np.testing.assert_allclose(np.diff(t), 2 * 86400.0)  # days -> seconds
    np.testing.assert_allclose(exp, 1000.0 / 1.1)
    np.testing.assert_allclose(yerr, 0.1)


def test_read_data2_generic(tmp_path):
    f = tmp_path / "generic.dat"
    f.write_text(
        "mjd\trate\terror\texposure\tbkgrate\tbkgerr\n"
        "100.0\t1.0\t0.1\t500.0\t0.01\t0.001\n"
        "101.0\t1.2\t0.1\t500.0\t0.01\t0.001\n"
        "102.0\t1.4\t0.1\t500.0\t0.01\t0.001\n"
    )
    t, y, yerr, exp, bkg_counts, bkg_err = readingutils.read_data2(str(f), tmin=100.5)
    assert len(t) == 2
    np.testing.assert_allclose(t, np.array([101.0, 102.0]) * 86400.0)
    np.testing.assert_allclose(bkg_counts, 0.01 * 500.0)


def test_read_zero_point(tmp_path):
    f = tmp_path / "t0.date"
    f.write_text("some header\nanother line\n55234.5\n")
    assert readingutils.read_zero_point(str(f)) == 55234.5


def test_readPCUL_single_row(tmp_path):
    f = tmp_path / "PCUL.qdp"
    header = (
        "READ TERR 1 2\n!MJD\n"
        "MJD\tT_+ve\tT_-ve\tRate\tRatepos\tRateneg\tSNR\tBGrate\tBGerr\t"
        "CorrFact\tCtsInSrc\tBGInSrc\tExposure\tSigma\tSNR2\tObsID\n"
    )
    f.write_text(header + "50000\t0.5\t-0.5\t0.05\t0.0\t0.0\t1.0\t0.01\t0.001\t1.1\t3\t1.0\t800.0\t1.0\t1.0\t0001")
    data = readingutils.readPCUL(str(f))
    assert len(data) == 1  # the single-row squeeze is re-expanded
    assert data["Exposure"][0] == 800.0
    assert len(readingutils.readPCUL(str(f), minExposure=900)) == 0


def test_readPCHR(tmp_path):
    f = tmp_path / "PCHR.qdp"
    header = (
        "READ TERR 1 2\n!MJD\n"
        "MJD\tT_+ve\tT_-ve\tHR\tHRerr\tHRneg\tSoftSig\tHardSig\tSoftRate\t"
        "HardRate\tSoftErr\tHardErr\tExposure\tObsID\n"
    )
    rows = [
        "50000\t0.5\t-0.5\t0.8\t0.1\t-0.1\t5.0\t5.0\t1.0\t0.8\t0.1\t0.1\t1000.0\t0001",
        # HRerr > HR: rejected when reject_errors
        "50002\t0.5\t-0.5\t0.2\t0.5\t-0.5\t5.0\t5.0\t1.0\t0.2\t0.1\t0.1\t1000.0\t0002",
        # negative HR: always rejected
        "50004\t0.5\t-0.5\t-0.1\t0.1\t-0.1\t5.0\t5.0\t1.0\t0.1\t0.1\t0.1\t1000.0\t0003",
    ]
    f.write_text(header + "\n".join(rows))
    assert len(readingutils.readPCHR(str(f))) == 1
    assert len(readingutils.readPCHR(str(f), reject_errors=False)) == 2


def test_readPC_catalog(tmp_path):
    f = tmp_path / "PC_catalog.qdp"
    header = "READ TERR 1 2\n!catalog\n"
    rows = [
        "1000.0\t500.0\t-500.0\t1.0\t0.1\t-0.1",
        "3000.0\t500.0\t-500.0\t1.2\t0.1\t-0.1",
        "5000.0\t100.0\t-100.0\t1.4\t0.1\t-0.1",
    ]
    f.write_text(header + "\n".join(rows))
    data = readingutils.readPC_catalog(str(f), minExposure=300)
    assert len(data) == 2  # the 200 s exposure row filtered out


def test_read_best_fit(tmp_path):
    f = tmp_path / "best_fit.dat"
    f.write_text("parameter\tvalue\n1.0\t2.5\n2.0\t3.5\n")
    data = readingutils.read_best_fit(str(f))
    assert len(data) == 2
    assert data["value"][1] == 3.5


def test_fastio_arrays_writable(tmp_path):
    """Both parser tiers must return writable arrays:
    np.frombuffer over the C extension's bytes would be read-only."""
    from mind_the_gaps_tpu.io import load_table

    f = tmp_path / "w.dat"
    f.write_text("1.0 2.0\n3.0 4.0\n")
    arr = load_table(str(f))
    assert arr.flags.writeable
    arr[0, 0] = 9.0
    assert arr[0, 0] == 9.0


def test_fastio_warns_on_skipped_rows(tmp_path):
    """Ragged rows (e.g. an empty CSV field collapsed by the parser) are
    dropped with a warning instead of silently."""
    import pytest as _pytest

    from mind_the_gaps_tpu.io import load_table

    f = tmp_path / "ragged.csv"
    f.write_text("1,2,3\n4,,6\n7,8,9\n")
    with _pytest.warns(UserWarning, match="skipped"):
        arr = load_table(str(f))
    assert arr.shape == (2, 3)


def test_simple_lightcurve_explicit_delimiter(tmp_path):
    """An explicit delimiter must take the genfromtxt path: empty
    delimited fields become NaN instead of silently dropping the row."""
    f = tmp_path / "lc.csv"
    f.write_text(
        "t,rate,error\n" + "\n".join(f"{10.0*i:.1f},{1.0+0.1*i:.3f},0.05" for i in range(10))
    )
    lc = SimpleLightcurve(str(f), delimiter=",")
    assert lc.n == 10
    np.testing.assert_allclose(lc.times, 10.0 * np.arange(10))
