"""The port's native chunk-decode pool (credit_torch/native/fastload) and
the zarr reader that reads through it.

The pool is held bitwise against Python's own decoders (zlib, gzip,
zstandard) and the fixtures' written values, and the port's reader against
credit_tpu's Python path. credit_tpu's reader is kept on that path (its
`fastload.available` patched to False): its own library builds into one
path shared by every test worker.
"""

import gzip
import os
import shutil
import zlib
from pathlib import Path

import numpy as np
import pytest
import zstandard

from credit_tpu.data import zarrlite as jzarr
from credit_tpu.native import fastload as jfastload
from credit_torch.data import zarrlite as tzarr
from credit_torch.native import fastload
from torch_port_fixtures import H, STATS, VARS_3D, W, write_era5_store

REPO = Path(__file__).resolve().parents[1]
CODECS = {"raw": (fastload.CODEC_RAW, lambda b: b),
          "zlib": (fastload.CODEC_ZLIB, lambda b: zlib.compress(b, 1)),
          "gzip": (fastload.CODEC_GZIP, gzip.compress),
          "zstd": (fastload.CODEC_ZSTD, zstandard.ZstdCompressor().compress)}
DECODERS = {"raw": lambda b: b, "zlib": zlib.decompress, "gzip": gzip.decompress,
            "zstd": lambda b: zstandard.ZstdDecompressor().decompress(b, max_output_size=1 << 24)}


@pytest.fixture(autouse=True)
def python_reference_reader(monkeypatch):
    monkeypatch.setattr(jfastload, "available", lambda: False)


def _chunks(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((5, 7 + i % 3)).astype("<f4") for i in range(n)]


@pytest.mark.parametrize("n", [1, 64])
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_decode_batch_matches_python_decoders(codec, n):
    """n in-memory chunks of one codec, decoded by the pool, equal Python's
    decode of the same bytes and the arrays that were compressed, bitwise."""
    cid, compress = CODECS[codec]
    arrs = _chunks(n, seed=n)
    raws = [compress(a.tobytes()) for a in arrs]
    outs = [np.empty_like(a) for a in arrs]
    before = fastload.decoded
    fastload.decode_batch(raws, [cid] * n, outs)
    assert fastload.decoded - before >= n
    for raw, a, o in zip(raws, arrs, outs):
        assert o.tobytes() == DECODERS[codec](raw) == a.tobytes()


def test_read_decode_batch_missing_corrupt_and_mismatch(tmp_path):
    """A missing file leaves its (pre-filled) output as it was; a corrupt
    chunk and a size mismatch raise, naming the file; in-memory failures
    name the chunk's index."""
    a = np.arange(12, dtype="<f4")
    good = tmp_path / "0"
    good.write_bytes(zlib.compress(a.tobytes()))
    outs = [np.empty(12, "<f4"), np.full(12, -1.0, "<f4")]
    found = fastload.read_decode_batch([str(good), str(tmp_path / "nope")],
                                       [fastload.CODEC_ZLIB] * 2, outs)
    assert found.tolist() == [True, False]
    assert np.array_equal(outs[0], a) and (outs[1] == -1.0).all()
    bad = tmp_path / "1"
    bad.write_bytes(b"not a zlib stream")
    with pytest.raises(RuntimeError, match=f"{bad}: decode error"):
        fastload.read_decode_batch([str(good), str(bad)], [fastload.CODEC_ZLIB] * 2,
                                   [np.empty(12, "<f4") for _ in range(2)])
    with pytest.raises(RuntimeError, match=f"{good}: size mismatch"):
        fastload.read_decode_batch([str(good)], [fastload.CODEC_ZLIB], [np.empty(13, "<f4")])
    with pytest.raises(RuntimeError, match="chunk 1 failed: decode error"):
        fastload.decode_batch([zlib.compress(a.tobytes()), b"junk"], [fastload.CODEC_ZLIB] * 2,
                              [np.empty(12, "<f4") for _ in range(2)])
    with pytest.raises(RuntimeError, match="chunk 0 failed: size mismatch"):
        fastload.decode_batch([a.tobytes()], [fastload.CODEC_RAW], [np.empty(11, "<f4")])
    with pytest.raises(ValueError, match="C-contiguous"):
        fastload.decode_batch([a.tobytes()], [fastload.CODEC_RAW], [np.empty((4, 6), "<f4").T])


def test_codec_ids_and_capabilities():
    assert fastload.codec_id(None) == fastload.CODEC_RAW
    assert fastload.codec_id({"id": "zlib", "level": 1}) == fastload.CODEC_ZLIB
    assert fastload.codec_id({"id": "gzip"}) == fastload.CODEC_GZIP
    assert fastload.codec_id({"id": "blosc"}) is None
    caps = fastload._load().fl_capabilities()
    assert caps & 1
    assert fastload.codec_id({"id": "zstd"}) == (fastload.CODEC_ZSTD if caps & 2 else None)
    assert fastload.default_threads() >= 1


SELECTIONS = [None, (3,), (slice(2, 9), [0, 1, 2]), (slice(0, 41, 5), 1, slice(3, 29)),
              ([40, 0, 17], slice(None), slice(30, 34), slice(60, 64))]


@pytest.mark.parametrize("sel", range(len(SELECTIONS)))
def test_reader_matches_reference_on_the_seeded_store(tmp_path, sel):
    """ZarrArray.read through the pool equals credit_tpu's Python path
    bitwise on the seeded ERA5-like store, for selections across chunk
    edges; every chunk read went through the pool."""
    store = write_era5_store(tmp_path / "era5.zarr", tzarr.write_array)
    ours, ref = tzarr.open_group(store), jzarr.open_group(store)
    selection = SELECTIONS[sel]
    for name in (*VARS_3D, "SP", "LSM"):
        arr = ours[name]
        # time-indexed arrays take the leading axes, the static field the last
        s = None if selection is None else selection[:arr.ndim] if arr.ndim > 2 else selection[-2:]
        decoded, read = fastload.decoded, tzarr.chunks_read
        got = arr.read(s)
        assert fastload.decoded - decoded == tzarr.chunks_read - read > 0, name
        want = ref[name].read(s)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), name
    mean, std = STATS["U"]
    assert abs(float(ours["U"].read().mean()) - mean) < 0.1 * std
    assert ours["U"].read().shape[-2:] == (H, W)


@pytest.mark.parametrize("compressor", ["zlib", None], ids=["zlib", "uncompressed"])
def test_reader_fill_and_fortran_order(tmp_path, compressor):
    """A missing chunk reads as the fill value through the pool; an F-order
    array takes the Python path; both as credit_tpu reads them."""
    data = np.random.default_rng(3).standard_normal((5, 7, 9)).astype("<f4")
    tzarr.write_array(str(tmp_path), "a", data, chunks=(2, 3, 4), compressor=compressor)
    os.remove(tmp_path / "a" / "1.1.1")
    want = jzarr.open_group(str(tmp_path))["a"].read()
    decoded = fastload.decoded
    got = tzarr.open_group(str(tmp_path))["a"].read()
    assert got.tobytes() == want.tobytes() and (got[2:4, 3:6, 4:8] == 0).all()
    assert fastload.decoded - decoded == 3 * 3 * 3 - 1
    arr = tzarr.open_group(str(tmp_path))["a"]
    arr.order = "F"
    decoded = fastload.decoded
    arr.read((0,))
    assert fastload.decoded == decoded


def test_build_lands_under_build_dir():
    """The library is built under build/credit_torch/ at the root of the
    checkout, named by a hash, and nothing is written beside the source."""
    path = Path(fastload._load()._name)
    assert path.parent == REPO / "build" / "credit_torch"
    assert path.name.startswith("libfastload_") and path.suffix == ".so"
    assert fastload.build() == path
    native = REPO / "credit_torch" / "native"
    assert sorted(p.name for p in native.iterdir() if p.suffix in (".so", ".o")) == []


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source with a syntax error, or a compiler that does not exist,
    raises RuntimeError with the compiler's complaint; nothing half-built is
    left in the output directory."""
    src = tmp_path / "fastload.cpp"
    shutil.copy(fastload.SOURCE, src)
    src.write_text(src.read_text() + "\nthis is not C++;\n")
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="failed on .*fastload.cpp"):
        fastload.build(src, out)
    assert list(out.iterdir()) == []
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="cannot run the compiler"):
        fastload.build(fastload.SOURCE, out)
    assert list(out.iterdir()) == []


def test_concurrent_callers_share_the_pool():
    """More Python threads than cores decode at once (ctypes drops the GIL
    for each batch): every output is right and the shared count of decoded
    chunks loses no update. Each join has a timeout."""
    import sys
    import threading

    n_threads, per_call = 2 * (os.cpu_count() or 4), 16
    arrs = _chunks(per_call, seed=9)
    raws = [zlib.compress(a.tobytes(), 1) for a in arrs]
    bad = []

    def work():
        for _ in range(5):
            outs = [np.empty_like(a) for a in arrs]
            fastload.decode_batch(raws, [fastload.CODEC_ZLIB] * per_call, outs)
            if any(o.tobytes() != a.tobytes() for o, a in zip(outs, arrs)):
                bad.append(1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = fastload.decoded
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not bad and fastload.decoded - before == n_threads * 5 * per_call
