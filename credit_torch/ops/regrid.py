"""Lat-lon regridding: bilinear, nearest, first-order conservative (the
port of credit_tpu/ops/regrid.py).

Re-implements the reference's regridders (reference: credit/regrid.py:93
conservative, :134 bilinear, :155 nearest, :285 Regridder dispatch). Each
operator's index and weight tables are built once on the host in float64,
as credit_tpu builds them, and held as tensors (int64 indices, float32
weights) that follow the field's device at the first call. Applying one is
plain library work: `index_select` gathers on the last two dims for the
bilinear and nearest maps, two `torch.matmul`s for the separable
conservative one.

Layout: fields (..., lat, lon).
"""

from __future__ import annotations

import numpy as np
import torch


def _wrap_lon(lon):
    return np.mod(lon, 360.0)


class _Tables:
    """Constant tensors (the attributes named in `_tables`; None is left
    alone) that move to the field's device at the first call on it (the
    pre- and postblocks' convention)."""

    _tables: tuple = ()

    def _on(self, device: torch.device) -> None:
        for name in self._tables:
            t = getattr(self, name)
            if t is not None and t.device != device:
                setattr(self, name, t.to(device))


class BilinearRegridder(_Tables):
    _tables = ("j0", "j1", "i0", "i1", "wlat", "wlon")

    def __init__(self, src_lat, src_lon, dst_lat, dst_lon):
        src_lat = np.asarray(src_lat, np.float64)
        src_lon = _wrap_lon(np.asarray(src_lon, np.float64))
        dst_lat = np.asarray(dst_lat, np.float64)
        dst_lon = _wrap_lon(np.asarray(dst_lon, np.float64))
        # latitude: clamped linear interp on the (possibly descending) axis
        order = np.argsort(src_lat)
        lat_sorted = src_lat[order]
        j = np.clip(np.searchsorted(lat_sorted, dst_lat), 1, len(src_lat) - 1)
        j0, j1 = order[j - 1], order[j]
        wlat = np.clip((dst_lat - lat_sorted[j - 1])
                       / (lat_sorted[j] - lat_sorted[j - 1]), 0, 1)
        # longitude: periodic linear interp
        nlon = len(src_lon)
        dlon = 360.0 / nlon
        pos = (dst_lon - src_lon[0]) / dlon
        i0 = np.floor(pos).astype(np.int64) % nlon
        i1 = (i0 + 1) % nlon
        wlon = pos - np.floor(pos)
        self.j0, self.j1 = torch.from_numpy(j0), torch.from_numpy(j1)
        self.i0, self.i1 = torch.from_numpy(i0), torch.from_numpy(i1)
        self.wlat = torch.from_numpy(wlat.astype(np.float32))
        self.wlon = torch.from_numpy(wlon.astype(np.float32))

    def __call__(self, f: torch.Tensor) -> torch.Tensor:
        self._on(f.device)
        r0, r1 = f.index_select(-2, self.j0), f.index_select(-2, self.j1)
        f00, f01 = r0.index_select(-1, self.i0), r0.index_select(-1, self.i1)
        f10, f11 = r1.index_select(-1, self.i0), r1.index_select(-1, self.i1)
        wl = self.wlat[:, None]
        wo = self.wlon[None, :]
        return ((f00 * (1 - wo) + f01 * wo) * (1 - wl)
                + (f10 * (1 - wo) + f11 * wo) * wl)


class NearestRegridder(_Tables):
    _tables = ("j", "i")

    def __init__(self, src_lat, src_lon, dst_lat, dst_lon):
        src_lat = np.asarray(src_lat, np.float64)
        src_lon = _wrap_lon(np.asarray(src_lon, np.float64))
        dst_lat = np.asarray(dst_lat, np.float64)
        dst_lon = _wrap_lon(np.asarray(dst_lon, np.float64))
        self.j = torch.from_numpy(np.abs(dst_lat[:, None] - src_lat[None, :]).argmin(1))
        d = np.abs(dst_lon[:, None] - src_lon[None, :])
        d = np.minimum(d, 360.0 - d)
        self.i = torch.from_numpy(d.argmin(1))

    def __call__(self, f: torch.Tensor) -> torch.Tensor:
        self._on(f.device)
        return f.index_select(-2, self.j).index_select(-1, self.i)


class ConservativeRegridder(_Tables):
    """First-order conservative: destination cell = area-weighted mean of
    overlapping source cells (separable in lat/lon for regular grids)."""

    _tables = ("Wlat", "WlonT")

    def __init__(self, src_lat, src_lon, dst_lat, dst_lon):
        self.Wlat = torch.from_numpy(
            self._overlap_matrix_lat(src_lat, dst_lat).astype(np.float32))
        # (src lon, dst lon): the right operand of the second product
        self.WlonT = torch.from_numpy(
            np.ascontiguousarray(self._overlap_matrix_lon(src_lon, dst_lon).T.astype(np.float32)))

    @staticmethod
    def _edges(centers, periodic=False, span=360.0):
        c = np.asarray(centers, np.float64)
        e = np.empty(len(c) + 1)
        e[1:-1] = 0.5 * (c[:-1] + c[1:])
        if periodic:
            e[0] = c[0] - (e[1] - c[0])
            e[-1] = e[0] + span
        else:
            e[0] = c[0] - (e[1] - c[0])
            e[-1] = c[-1] + (c[-1] - e[-2])
        return e

    def _overlap_matrix_lat(self, src, dst):
        s = np.sort(np.asarray(src, np.float64))
        d = np.sort(np.asarray(dst, np.float64))
        se = np.clip(self._edges(s), -90, 90)
        de = np.clip(self._edges(d), -90, 90)
        # overlap in sin(lat) (area weight)
        se_s, de_s = np.sin(np.deg2rad(se)), np.sin(np.deg2rad(de))
        W = np.zeros((len(d), len(s)))
        for k in range(len(d)):
            lo, hi = de_s[k], de_s[k + 1]
            ov = np.clip(np.minimum(hi, se_s[1:]) - np.maximum(lo, se_s[:-1]), 0, None)
            if ov.sum() > 0:
                W[k] = ov / ov.sum()
        # restore original orderings
        src_order = np.argsort(np.asarray(src))
        dst_order = np.argsort(np.asarray(dst))
        Wo = np.zeros_like(W)
        Wo[dst_order[:, None], src_order[None, :]] = W
        return Wo

    def _overlap_matrix_lon(self, src, dst):
        s = _wrap_lon(np.asarray(src, np.float64))
        d = _wrap_lon(np.asarray(dst, np.float64))
        se = self._edges(np.sort(s), periodic=True)
        de = self._edges(np.sort(d), periodic=True)
        ns, nd = len(s), len(d)
        W = np.zeros((nd, ns))
        for k in range(nd):
            lo, hi = de[k], de[k + 1]
            for shift in (-360.0, 0.0, 360.0):
                ov = np.clip(np.minimum(hi, se[1:] + shift)
                             - np.maximum(lo, se[:-1] + shift), 0, None)
                W[k] += ov
            if W[k].sum() > 0:
                W[k] /= W[k].sum()
        so = np.argsort(s)
        do = np.argsort(d)
        Wo = np.zeros_like(W)
        Wo[do[:, None], so[None, :]] = W
        return Wo

    def __call__(self, f: torch.Tensor) -> torch.Tensor:
        self._on(f.device)
        return torch.matmul(torch.matmul(self.Wlat, f), self.WlonT)


def make_regridder(method: str, src_lat, src_lon, dst_lat, dst_lon):
    cls = {"bilinear": BilinearRegridder, "nearest": NearestRegridder,
           "conservative": ConservativeRegridder}[method]
    return cls(src_lat, src_lon, dst_lat, dst_lon)
