"""The window cache's writer, ``utils.savez_compressed_threaded``, against
``np.savez_compressed``: the arrays, their order and dtypes as ``np.load``
reads them, a zip that ``zipfile`` tests clean, each member's CRC-32 and
length, and the file's size."""

import io
import struct
import zipfile
import zlib

import numpy as np
import pytest

from genomad_torch import utils

WINDOW = 6000


def _cache(n_windows, content, rng):
    """The arrays of a window cache: (n, 6000) base codes (ACGT 0-3, N 4),
    names and ids as ``nn_pipeline.encode_windows`` returns them."""
    bases = rng.integers(0, 4, (n_windows, WINDOW), dtype=np.uint8)
    if content == "n_rich":  # runs of 100 N over 70% of each window
        bases[np.repeat(rng.random((n_windows, WINDOW // 100)) < 0.7, 100, axis=1)] = 4
    n_contigs = -(-n_windows // 14)
    names = np.array([f"contig_{i}" for i in range(n_contigs)])
    ids = np.sort(rng.integers(0, max(n_contigs, 1), n_windows)).astype(np.int32)
    return {"bases": bases, "contig_names": names, "contig_ids": ids}


def _member_bytes(array):
    buf = io.BytesIO()
    np.save(buf, array)
    return buf.tell()


def _deflate_stream(path, info):
    """The member's raw deflate bytes, found through its local header."""
    with open(path, "rb") as f:
        f.seek(info.header_offset + 26)
        name_len, extra_len = struct.unpack("<2H", f.read(4))
        f.seek(name_len + extra_len, 1)
        return f.read(info.compress_size)


def _chunk_bytes(size, k):
    """A chunk length that cuts ``size`` bytes into ``k`` chunks, the last
    one shorter wherever such a length exists."""
    first = -(-size // k)
    uneven = (c for c in range(first, first + k + 1) if -(-size // c) == k and size % c)
    return next(uneven, first)


CASES = [(n, k, "acgt") for n in (0, 1, 700) for k in (1, 2, 3, 7, 16)]
CASES += [(700, k, "n_rich") for k in (1, 2, 3, 7, 16)]


@pytest.mark.parametrize("n_windows,k,content", CASES)
def test_chunked_cache_reads_as_savez_compressed(tmp_path, n_windows, k, content):
    arrays = _cache(n_windows, content, np.random.default_rng(n_windows + k))
    ours, ref = tmp_path / "ours" / "cache.npz", tmp_path / "ref.npz"
    ours.parent.mkdir()
    size = _member_bytes(arrays["bases"])
    chunk_bytes = _chunk_bytes(size, k)
    chunks = utils.savez_compressed_threaded(ours, k, chunk_bytes=chunk_bytes, **arrays)
    np.savez_compressed(ref, **arrays)

    assert chunks["bases"] == k and list(chunks) == list(arrays)
    assert k == 1 or size % chunk_bytes or (n_windows, k) == (0, 16)  # 16 x 8 = 128 bytes
    assert [p.name for p in ours.parent.iterdir()] == ["cache.npz"]  # no temporary file left
    assert ours.stat().st_mode == ref.stat().st_mode
    loaded, expected = np.load(ours), np.load(ref)
    assert loaded.files == expected.files == list(arrays)
    for key in arrays:
        assert loaded[key].dtype == expected[key].dtype and loaded[key].shape == expected[key].shape
        np.testing.assert_array_equal(loaded[key], expected[key])

    with zipfile.ZipFile(ours) as z, zipfile.ZipFile(ref) as zr:
        assert z.testzip() is None
        for info, ref_info in zip(z.infolist(), zr.infolist()):
            assert info.compress_type == zipfile.ZIP_DEFLATED
            # one deflate stream that ends in a final block, with nothing after it
            inflate = zlib.decompressobj(-15)
            assert inflate.decompress(_deflate_stream(ours, info)) == z.read(info)
            assert inflate.eof and not inflate.unused_data
            assert (info.filename, info.CRC, info.file_size) == (ref_info.filename, ref_info.CRC, ref_info.file_size)
            if k == 1:  # one stream at the same level: the same deflate bytes
                assert info.compress_size == ref_info.compress_size
    if n_windows == 700 and content == "acgt":
        assert abs(ours.stat().st_size / ref.stat().st_size - 1) < 0.01


def test_sizes_and_offsets_past_the_zip64_limit_go_to_zip64_fields(tmp_path, monkeypatch):
    monkeypatch.setattr(utils, "_ZIP64_LIMIT", 100)
    arrays = _cache(3, "acgt", np.random.default_rng(1))
    path = tmp_path / "cache.npz"
    assert utils.savez_compressed_threaded(path, 4, chunk_bytes=4096, **arrays)["bases"] == 4
    assert b"PK\x06\x06" in path.read_bytes()  # the zip64 end of central directory
    with zipfile.ZipFile(path) as z:
        assert z.testzip() is None
        assert [i.file_size for i in z.infolist()] == [_member_bytes(a) for a in arrays.values()]
    loaded = np.load(path)
    for key, array in arrays.items():
        np.testing.assert_array_equal(loaded[key], array)


def test_an_array_that_needs_pickles_writes_nothing(tmp_path):
    path = tmp_path / "cache.npz"
    with pytest.raises(ValueError, match="pickles"):
        utils.savez_compressed_threaded(path, 2, bases=np.zeros(3, np.uint8), names=np.array([None, 1]))
    assert list(tmp_path.iterdir()) == []
