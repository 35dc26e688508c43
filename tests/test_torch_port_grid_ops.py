"""Parity of the port's grid operators with credit_tpu's: the three
regridders (credit_torch/ops/regrid.py) and the regrid preblock with
ascending and descending latitudes and longitudes on -180..180 and 0..360,
the SHT (credit_torch/ops/sht.py: its Legendre tables, bitwise, and every
method on equiangular and legendre-gauss latitudes) and
metrics.divergent_rotational_spectra, f32 on the CPU from seeded numpy
inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from credit_tpu import metrics as jmetrics
from credit_tpu import preblock as jpre
from credit_tpu.data.channels import ChannelSchema as JSchema
from credit_tpu.grid import Grid as JGrid
from credit_tpu.ops import regrid as jregrid
from credit_tpu.ops import sht as jsht
from credit_torch import metrics as tmetrics
from credit_torch import preblock as tpre
from credit_torch.data.channels import ChannelSchema
from credit_torch.grid import Grid
from credit_torch.ops import regrid as tregrid
from credit_torch.ops import sht as tsht
from torch_port_fixtures import two_torch_threads  # noqa: F401 (an autouse fixture)

METHODS = ("bilinear", "nearest", "conservative")
# the regridders' source grids: 23 latitudes ascending or descending, 48
# longitudes from 0 or from -180; the destination: the 0.5x-offset 31x40
# grid (a finer one in latitude, coarser in longitude), 0..360
SRC_LAT = {"ascending": np.linspace(-88.0, 88.0, 23), "descending": np.linspace(88.0, -88.0, 23)}
SRC_LON = {"0..360": np.arange(48) * 7.5, "-180..180": np.arange(48) * 7.5 - 180.0}
DST_LAT, DST_LON = np.linspace(89.0, -89.0, 31), np.arange(40) * 9.0 + 4.5
REGRID_TOL = 1e-6  # of max |x|, f32


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max() if scale is None else scale
    err = np.abs(got - want).max() / scale
    assert err <= tol, err


# --------------------------------------------------------------- regrid
@pytest.mark.parametrize("lon", list(SRC_LON))
@pytest.mark.parametrize("lat", list(SRC_LAT))
@pytest.mark.parametrize("method", METHODS)
def test_regridder_matches_reference(method, lat, lon):
    """Each regridder's tables equal credit_tpu's (indices exactly, weights
    bitwise in f32) and its output on a (3, 2, 23, 48) field stays within
    1e-6 of max |x|; both ways, source to destination and back."""
    grids = [(SRC_LAT[lat], SRC_LON[lon], DST_LAT, DST_LON),
             (DST_LAT, DST_LON, SRC_LAT[lat], SRC_LON[lon])]
    for k, (slat, slon, dlat, dlon) in enumerate(grids):
        ours = tregrid.make_regridder(method, slat, slon, dlat, dlon)
        ref = jregrid.make_regridder(method, slat, slon, dlat, dlon)
        names = {"bilinear": ("j0", "j1", "i0", "i1", "wlat", "wlon"), "nearest": ("j", "i"),
                 "conservative": ("Wlat",)}[method]
        for name in names:
            assert np.array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name))), name
        if method == "conservative":
            assert np.array_equal(ours.WlonT.numpy().T, np.asarray(ref.Wlon))
        f = _rand((3, 2, len(slat), len(slon)), 10 + k)
        _close(ours(torch.from_numpy(f)).numpy(), ref(jnp.asarray(f)), REGRID_TOL,
               np.abs(f).max())


def test_conservative_regrid_keeps_a_constant_field():
    """Each destination cell is a mean of the source cells it overlaps (f32
    tables made on the CPU): a constant field stays constant."""
    rg = tregrid.ConservativeRegridder(SRC_LAT["descending"], SRC_LON["-180..180"], DST_LAT,
                                       DST_LON)
    assert rg.Wlat.device.type == "cpu" and rg.Wlat.dtype == torch.float32
    out = rg(torch.full((2, 23, 48), 3.0))
    assert out.shape == (2, 31, 40)
    np.testing.assert_allclose(out.numpy(), 3.0, rtol=1e-6)


@pytest.mark.parametrize("method", METHODS)
def test_regrid_preblock_matches_reference(method):
    """The regrid preblock from the config (destination from the model
    grid) on a (2, 2, 23, 48, C) input against credit_tpu's, within 1e-6
    of max |x|."""
    conf = {"data": {"source": {"E": {"levels": [0.0, 1.0], "variables": {
        "prognostic": {"vars_3D": ["U"], "vars_2D": ["SP"]}}}}}}
    entry = {"type": "regrid", "method": method, "src_lat": SRC_LAT["ascending"].tolist(),
             "src_lon": SRC_LON["-180..180"].tolist()}
    grid = Grid(lat=DST_LAT, lon=DST_LON)
    (ours,) = tpre.build_preblocks({"preblocks": [entry]}, ChannelSchema.from_config(conf),
                                   grid=grid)
    (ref,) = jpre.build_preblocks({"preblocks": [entry]}, JSchema.from_config(conf),
                                  grid=JGrid(lat=DST_LAT, lon=DST_LON))
    assert type(ours).__name__ == "RegridPreblock"
    x = _rand((2, 2, 23, 48, 3), 3)
    got = ours(torch.from_numpy(x))
    assert got.shape == (2, 2, 31, 40, 3)
    _close(got.numpy(), ref(jnp.asarray(x)), REGRID_TOL, np.abs(x).max())


# --------------------------------------------------------------- SHT
NLAT, NLON = 33, 64
SHT_TOL = 1e-5  # of the largest coefficient or value


def _lat(grid):
    if grid == "legendre-gauss":
        return np.rad2deg(np.arcsin(np.polynomial.legendre.leggauss(NLAT)[0]))
    return np.linspace(90.0, -90.0, NLAT)


GRIDS = ("equiangular", "legendre-gauss")


@pytest.fixture(scope="module")
def shts():
    return {g: (tsht.SHT(_lat(g), NLON, grid=g), jsht.SHT(_lat(g), NLON, grid=g)) for g in GRIDS}


@pytest.mark.parametrize("grid", GRIDS)
def test_sht_tables_bitwise(shts, grid):
    """The float32 tables and quadrature weights equal credit_tpu's bit for
    bit, and the float64 Legendre tables built a degree at a time equal its
    (m, l) loops'."""
    ours, ref = shts[grid]
    for name, a, b in [("pct", ours.pct, ref.pct), ("pw", ours.pw, ref.pw),
                       ("dpct", ours.dpct, ref.dpct), ("w", ours.w, ref._wvec_cached),
                       ("coslat", ours.coslat, ref.coslat),
                       ("laplacian", ours.laplacian, ref.laplacian)]:
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), np.asarray(b)), name
    x = np.sin(np.deg2rad(_lat(grid)))
    assert np.array_equal(tsht._legendre_table(NLAT, 20, x), jsht._legendre_table(NLAT, 20, x))
    assert np.array_equal(tsht._dlegendre_dtheta(NLAT, 20, x),
                          jsht._dlegendre_dtheta(NLAT, 20, x))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("mmax", [20, None])
def test_sht_tables_built_by_torch_bitwise(shts, grid, mmax):
    """The tables as a CUDA SHT builds them (torch float64 ops on its
    device; here on the CPU) equal numpy's, and so credit_tpu's, bit for
    bit, with every order and with orders cut below the degrees."""
    lat = _lat(grid)
    x = np.sin(np.deg2rad(lat))
    w = tsht._quadrature(lat, grid)
    mm = mmax or shts[grid][0].mmax
    for name, a, b in zip(("pct", "pw", "dpct"), tsht._tables(NLAT, mm, x, w),
                          tsht._tables(NLAT, mm, x, w, torch.device("cpu"))):
        assert b.dtype == torch.float32 and np.array_equal(a, b.numpy()), name
    if mmax is None:
        ref = shts[grid][1]
        assert np.array_equal(tsht._tables(NLAT, mm, x, w, torch.device("cpu"))[0].numpy(),
                              np.asarray(ref.pct))
    assert np.array_equal(tsht._quadrature(_lat(grid), grid), jsht._quadrature(_lat(grid), grid))


def _spec(ref, seed):
    """Seeded complex coefficients (2, lmax, mmax) (complex64)."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((2, ref.lmax, ref.mmax, 2)).astype(np.float32)
    return (c[..., 0] + 1j * c[..., 1]).astype(np.complex64)


@pytest.mark.parametrize("method", ["grid2spec", "spec2grid", "filter", "laplacian_grid",
                                    "inverse_laplacian", "grad_from_spec",
                                    "uv_from_streamfunction", "vrtdiv_spec"])
@pytest.mark.parametrize("grid", GRIDS)
def test_sht_method_matches_reference(shts, grid, method):
    """Each SHT method on seeded (2, 3, 33, 64) fields or (2, 33, 33)
    coefficients against credit_tpu's, within 1e-5 of the largest output
    value or coefficient."""
    ours, ref = shts[grid]
    f = _rand((2, 3, NLAT, NLON), 1)
    flm = _spec(ref, 2)
    if method in ("grid2spec", "laplacian_grid"):
        args, jargs = (torch.from_numpy(f),), (jnp.asarray(f),)
    elif method == "filter":
        r = np.linspace(1.0, 0.0, ref.lmax).astype(np.float32)
        args, jargs = (torch.from_numpy(f), torch.from_numpy(r)), (jnp.asarray(f), jnp.asarray(r))
    elif method == "vrtdiv_spec":
        u, v = _rand((2, NLAT, NLON), 3), _rand((2, NLAT, NLON), 4)
        args, jargs = ((torch.from_numpy(u), torch.from_numpy(v)),
                       (jnp.asarray(u), jnp.asarray(v)))
    else:
        args, jargs = (torch.from_numpy(flm),), (jnp.asarray(flm),)
    got, want = getattr(ours, method)(*args), getattr(ref, method)(*jargs)
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == (torch.complex64 if jnp.iscomplexobj(b) else torch.float32)
        _close(a.numpy(), b, SHT_TOL)


@pytest.mark.parametrize("shape", [(NLAT, NLON), (2, 3, 17, 32)])
def test_divergent_rotational_spectra_matches_reference(shape):
    """Per-degree rotational and divergent KE spectra of seeded winds on
    the regular grid, within 1e-5 of each spectrum's largest degree."""
    h, w = shape[-2:]
    u, v = _rand(shape, 5) * 10, _rand(shape, 6) * 8
    want = jmetrics.divergent_rotational_spectra(jnp.asarray(u), jnp.asarray(v),
                                                 JGrid.regular(h, w))
    grid = Grid.regular(h, w)
    got = tmetrics.divergent_rotational_spectra(torch.from_numpy(u), torch.from_numpy(v), grid)
    for a, b in zip(got, want):
        assert a.shape == (*shape[:-2], h)
        _close(a.numpy(), b, SHT_TOL)
