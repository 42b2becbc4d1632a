"""The port's NIfTI gzip codec (``deepwmh_tpu_torch/native/cc3d.cpp``'s zlib
inflate / deflate through ``core/nifti.py``) against the JAX package's
(PARITY C14): the same bytes at each level, each package reading the other's
files, multi-member and chunked streams read whole, a truncated stream
raising, the read's first buffer sized from the stream's trailer, and no
quiet route to Python's ``gzip`` when the library cannot be built. Small
volumes: every test here runs in well under a second.
"""

import gzip
import os

import numpy as np
import pytest

from deepwmh_tpu.core import nifti as jnifti
from deepwmh_tpu_torch import native
from deepwmh_tpu_torch.core import nifti

SHAPE = (24, 28, 20)


def _volume(seed=0):
    """A sparse f32 volume (3% non-zero, as the pipeline's masks and
    probabilities are)."""
    rs = np.random.RandomState(seed)
    v = (rs.rand(*SHAPE) * 100).astype(np.float32)
    v[rs.rand(*SHAPE) > 0.03] = 0
    return v


def _header(jax=False):
    hdr = (jnifti if jax else nifti).NiftiHeader()
    hdr.set_shape(SHAPE)
    hdr.set_zooms((1.0, 1.25, 2.0))
    return hdr


@pytest.mark.parametrize("level", [1, 4, 9])
def test_port_files_have_jax_bytes(tmp_path, level):
    """The port's ``.nii.gz`` is byte for byte the JAX package's at each
    level, native or inside ``python_path()``, and the native path is the
    one taken."""
    vol = _volume()
    native.reset_counts()
    nifti.save_nifti(vol, _header(), str(tmp_path / "port.nii.gz"), level=level)
    assert native.CALLS["gzip_deflate"] == 1 and native.PYTHON_CALLS["gzip_deflate"] == 0
    with native.python_path():
        nifti.save_nifti(vol, _header(), str(tmp_path / "plain.nii.gz"), level=level)
    assert native.PYTHON_CALLS["gzip_deflate"] == 1
    jnifti.save_nifti(vol, _header(jax=True), str(tmp_path / "jax.nii.gz"), level=level)
    want = (tmp_path / "jax.nii.gz").read_bytes()
    assert (tmp_path / "port.nii.gz").read_bytes() == want
    assert (tmp_path / "plain.nii.gz").read_bytes() == want


def test_each_package_reads_the_others_files(tmp_path):
    vol = _volume(1)
    nifti.save_nifti(vol, _header(), str(tmp_path / "port.nii.gz"))
    nifti.save_nifti_scaled_int16(vol, _header(), str(tmp_path / "port16.nii.gz"))
    jnifti.save_nifti(vol, _header(jax=True), str(tmp_path / "jax.nii.gz"))
    native.reset_counts()
    got, hdr = nifti.load_nifti(str(tmp_path / "jax.nii.gz"))
    assert native.CALLS["gzip_inflate"] == 1 and native.PYTHON_CALLS["gzip_inflate"] == 0
    np.testing.assert_array_equal(got, vol)
    assert tuple(hdr.zooms[:3]) == (1.0, 1.25, 2.0)
    np.testing.assert_array_equal(jnifti.load_nifti_simple(str(tmp_path / "port.nii.gz")), vol)
    np.testing.assert_array_equal(jnifti.load_nifti_simple(str(tmp_path / "port16.nii.gz")),
                                  nifti.load_nifti_simple(str(tmp_path / "port16.nii.gz")))
    with native.python_path():
        np.testing.assert_array_equal(nifti.load_nifti_simple(str(tmp_path / "jax.nii.gz")), vol)


def test_multi_member_gzip_reads_whole(tmp_path):
    """A bgzip / pigz style file of three members: the trailer's size is
    the last member's only, so the first buffer is short and grows; both
    packages read the whole volume."""
    vol = _volume(2)
    nifti.save_nifti(vol, _header(), str(tmp_path / "one.nii"))
    raw = (tmp_path / "one.nii").read_bytes()
    cuts = (0, 100, len(raw) // 2, len(raw))
    blob = b"".join(gzip.compress(raw[a:b], mtime=0) for a, b in zip(cuts, cuts[1:]))
    path = str(tmp_path / "multi.nii.gz")
    with open(path, "wb") as f:
        f.write(blob)
    assert native.gzip_isize(blob) == len(raw) - len(raw) // 2
    assert bytes(native.gzip_inflate_host(blob)) == raw
    np.testing.assert_array_equal(nifti.load_nifti_simple(path), vol)
    np.testing.assert_array_equal(jnifti.load_nifti_simple(path), vol)


def test_streams_longer_than_the_chunk_read_and_write_whole(tmp_path):
    """zlib fed 256 bytes at a time (``gzip_set_chunk_for_testing``): the
    deflate gives the one-chunk bytes and the inflate the whole volume."""
    vol = _volume(3)
    one = str(tmp_path / "one.nii.gz")
    nifti.save_nifti(vol, _header(), one)
    native.gzip_set_chunk_for_testing(256)
    try:
        assert os.path.getsize(one) > 3 * 256
        chunked = str(tmp_path / "chunked.nii.gz")
        nifti.save_nifti(vol, _header(), chunked)
        np.testing.assert_array_equal(nifti.load_nifti_simple(one), vol)
    finally:
        native.gzip_set_chunk_for_testing(0)
    assert open(chunked, "rb").read() == open(one, "rb").read()


def test_truncated_or_corrupt_stream_raises(tmp_path):
    vol = _volume(4)
    path = str(tmp_path / "v.nii.gz")
    nifti.save_nifti(vol, _header(), path)
    blob = open(path, "rb").read()
    for bad in (blob[: len(blob) // 2], blob[:-8], b"\x1f\x8b" + b"\x00" * 30):
        with open(path, "wb") as f:
            f.write(bad)
        with pytest.raises(native.GzipError):
            nifti.load_nifti(path)
        assert not nifti.try_load_nifti(path)


def test_first_buffer_is_the_trailer_size(tmp_path, monkeypatch):
    """One inflate call of exactly the stream's size for a single member
    (not a guess from the compressed size, which restarts on every
    underestimate)."""
    vol = _volume(5)
    path = str(tmp_path / "v.nii.gz")
    nifti.save_nifti(vol, _header(), path)
    lib = native.get_lib()
    real, caps = lib.gzip_inflate, []

    def spy(src, n_src, dst, cap):
        caps.append(cap)
        return real(src, n_src, dst, cap)

    monkeypatch.setattr(lib, "gzip_inflate", spy)
    nifti.load_nifti(path)
    assert caps == [348 + 4 + vol.nbytes]


def test_unbuildable_library_raises_on_gzip(tmp_path, monkeypatch):
    """No quiet route to Python's gzip: without a compiler a ``.nii.gz``
    read and write raise ``NativeLibraryError``; a plain ``.nii`` needs no
    library."""
    nifti.save_nifti(_volume(6), _header(), str(tmp_path / "v.nii.gz"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", "no-such-compiler-for-deepwmh")
    with pytest.raises(native.NativeLibraryError, match="C\\+\\+ compiler"):
        nifti.load_nifti(str(tmp_path / "v.nii.gz"))
    with pytest.raises(native.NativeLibraryError):
        nifti.save_nifti(_volume(6), _header(), str(tmp_path / "w.nii.gz"))
    nifti.save_nifti(_volume(6), _header(), str(tmp_path / "w.nii"))
    np.testing.assert_array_equal(nifti.load_nifti_simple(str(tmp_path / "w.nii")), _volume(6))
