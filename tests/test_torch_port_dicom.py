"""The port's DICOM import (deepwmh_tpu_torch.core.{jpegcodec, jlscodec,
j2kcodec, dicom}, native/ and cli/dcm2niix) against the JAX package's on
the same seeded inputs, and DICOM -> dcm2niix -> predict through both.

- Codecs: on every stream family the JAX package's codec tests build, the
  port's ``decode`` equals JAX's exactly (values, dtype, precision); the
  port's encoders give JAX's bytes; malformed and unsupported streams end
  the same way in both (the same exception class, or equal arrays).
- Plain paths: the port's native and Python decoders are bit-equal on each
  of the three native routes, and a library that cannot be built raises.
- DICOM: both ``convert_directory`` write NIfTIs whose decompressed bytes
  (header and voxels) are equal, for every syntax and special case (both
  deflate through zlib, so the gzip bytes agree too).
- The slice: a JPEG Lossless series of the fixture phantom through each
  package's dcm2niix and run_predict: > 99.9% voxel agreement on each mask,
  foreground probability within atol 5e-3.
"""

import gzip
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image as PILImage

from deepwmh_tpu.core import dicom as jdicom
from deepwmh_tpu.core import j2kcodec as jj2k
from deepwmh_tpu.core import jlscodec as jjls
from deepwmh_tpu.core import jpegcodec as jjpeg
from deepwmh_tpu_torch import native
from deepwmh_tpu_torch.cli import dcm2niix as port_cli
from deepwmh_tpu_torch.core import dicom as pdicom
from deepwmh_tpu_torch.core import j2kcodec as pj2k
from deepwmh_tpu_torch.core import jlscodec as pjls
from deepwmh_tpu_torch.core import jpegcodec as pjpeg

import torch_port_dicom as W
from test_dicom import (_el_explicit, _rle_encode_segment, _sq_item, _undef_item, _undef_sq,
                        _write_body, make_series, write_test_dicom)
from test_j2kcodec import _mk, _split_into_tile_parts, _style_image
from test_jpegcodec import _mri_like


def _openjpeg():
    try:
        from openjpeg_enc import get_encoder

        return get_encoder()
    except Exception as e:  # the JAX package's own tests skip likewise
        pytest.skip("libopenjp2 encoder unavailable: %s" % e)


def _pil(img, mode="L", fmt="JPEG2000", **kw):
    buf = io.BytesIO()
    PILImage.fromarray(img, mode).save(buf, fmt, **kw)
    return buf.getvalue()


def _pil16(img16, **kw):
    buf = io.BytesIO()
    pimg = PILImage.new("I;16", img16.shape[::-1])
    pimg.frombytes(img16.astype("<u2").tobytes())
    pimg.save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def _outcome(decode, data):
    try:
        arr, prec = decode(data)
    except Exception as e:
        return ("raises", type(e).__name__)
    return ("ok", np.asarray(arr), prec)


def assert_same_decode(jmod, pmod, data):
    want, got = _outcome(jmod.decode, data), _outcome(pmod.decode, data)
    assert got[0] == want[0], (got[:2], want[:2])
    if want[0] == "raises":
        assert got[1] == want[1]
        return None
    assert got[2] == want[2] and got[1].dtype == want[1].dtype
    np.testing.assert_array_equal(got[1], want[1])
    return got[1]


# ---------------------------------------------------------------------- #
# codecs: the port decodes JAX's streams to the same values
# ---------------------------------------------------------------------- #


def _jpeg_lossless(precision, predictor, **kw):
    top = (1 << precision) - 1
    img = _mri_like((23, 31), top, seed=predictor).astype(np.uint8 if precision <= 8 else np.uint16)
    return jjpeg.encode_lossless(img, predictor=predictor, precision=precision, **kw)


JPEG_STREAMS = {
    **{"lossless_p%d_%dbit" % (p, b): (lambda p=p, b=b: _jpeg_lossless(b, p))
       for p in range(1, 8) for b in (8, 12, 16)},
    "lossless_noise16": lambda: jjpeg.encode_lossless(
        (np.random.RandomState(7).rand(40, 56) * 65535).astype(np.uint16), predictor=1,
        precision=16),
    "lossless_point_transform": lambda: jjpeg.encode_lossless(
        (np.random.RandomState(2).rand(16, 18) * 255).astype(np.uint8), predictor=1, precision=8,
        point_transform=2),
    "lossless_restarts": lambda: jjpeg.encode_lossless(
        _mri_like((40, 24), 4095, seed=5).astype(np.uint16), predictor=4, precision=12,
        restart_interval=24 * 5),
    "dct_8bit": lambda: jjpeg.encode_dct(_mri_like((64, 72), 255, seed=3).astype(np.uint8),
                                         quality=95, precision=8),
    "dct_12bit": lambda: jjpeg.encode_dct(_mri_like((64, 72), 4095, seed=3).astype(np.uint16),
                                          quality=95, precision=12),
    "dct_restarts": lambda: jjpeg.encode_dct(_mri_like((48, 40), 255, seed=4).astype(np.uint8),
                                             quality=90, precision=8, restart_interval=7),
    "pil_baseline": lambda: _pil(_mri_like((100, 140), 255, seed=1).astype(np.uint8), "L",
                                 "JPEG", quality=95),
    "pil_colour": lambda: _pil(np.stack([_mri_like((64, 80), 255, seed=6).astype(np.uint8)] * 3,
                                        -1) // np.array([1, 2, 3], np.uint8), "RGB", "JPEG",
                               quality=92),
}


@pytest.mark.parametrize("family", sorted(JPEG_STREAMS))
def test_jpeg_decode_matches_jax(family):
    assert_same_decode(jjpeg, pjpeg, JPEG_STREAMS[family]())


def _head(n=96, seed=7):
    rng = np.random.RandomState(seed)
    g = np.mgrid[0:n, 0:n]
    r = np.sqrt((g[0] - n / 2) ** 2 + (g[1] - n / 2) ** 2)
    return ((r < 40) * (900 + 80 * rng.randn(n, n))).clip(0, 4095).astype(np.uint16)


def _piecewise():
    img = np.zeros((48, 64), np.uint8)
    img[10:30, 12:50] = 200
    img[15:22, 20:28] = 90
    return img


def _gradient():
    rng = np.random.RandomState(6)
    yy, xx = np.mgrid[0:64, 0:80]
    return (2000 + 500 * np.sin(yy / 9.0) + 300 * np.cos(xx / 7.0)
            + rng.randn(64, 80) * 15).astype(np.uint16)


def _noise(shape, precision, seed):
    return (np.random.RandomState(seed).rand(*shape) * ((1 << precision) - 1)).astype(
        np.uint8 if precision <= 8 else np.uint16)


JLS_IMAGES = {
    **{"noise_%dbit" % b: (lambda b=b: (_noise((37, 53), b, b), b, 0)) for b in (8, 10, 12, 16)},
    "flat_run_mode": lambda: (np.full((31, 45), 117, np.uint8), 8, 0),
    "piecewise_runs": lambda: (_piecewise(), 8, 0),
    "binary_run_churn": lambda: (((np.random.RandomState(5).rand(50, 61) > 0.5) * 255).astype(
        np.uint8), 8, 0),
    "gradient_bias": lambda: (_gradient(), 12, 0),
    "head": lambda: (_head(), 12, 0),
    **{"near%d" % k: (lambda k=k: (_noise((40, 44), 12, 8), 12, k)) for k in (1, 2, 3)},
    "head_near2": lambda: (_head(), 12, 2),
    **{"edge_%dx%d" % s: (lambda s=s: (_noise(s, 8, 9), 8, 0))
       for s in [(1, 1), (1, 17), (23, 1), (2, 2), (3, 257)]},
}


@pytest.mark.parametrize("family", sorted(JLS_IMAGES))
def test_jpegls_decode_matches_jax(family):
    img, precision, near = JLS_IMAGES[family]()
    got = assert_same_decode(jjls, pjls, jjls.encode(img, near=near, precision=precision))
    assert np.abs(got.astype(np.int64) - img.astype(np.int64)).max() <= near


def _openjpeg_stream(seed=0, **kw):
    return _openjpeg().encode(_style_image(seed=seed), prec=12, levels=3, **kw)


J2K_STREAMS = {
    **{"pil_lossless_%dx%d" % s: (lambda s=s: _pil(_mk(*s).astype(np.uint8), irreversible=False))
       for s in [(40, 56), (65, 67), (31, 257), (8, 8), (1, 50), (128, 96)]},
    "pil_noise": lambda: _pil((np.random.RandomState(3).rand(77, 91) * 255).astype(np.uint8),
                              irreversible=False),
    "pil_rgb_rct": lambda: _pil(np.stack([_mk(48, 60).astype(np.uint8)] * 3, -1)[:, ::-1].copy(),
                                "RGB", irreversible=False),
    "pil_97": lambda: _pil(_mk(72, 88).astype(np.uint8), irreversible=True, quality_mode="rates",
                           quality_layers=[0]),
    "pil_layers": lambda: _pil(_mk(80, 80).astype(np.uint8), irreversible=False,
                               quality_mode="rates", quality_layers=[20, 5, 1]),
    "pil_codeblock_resolutions": lambda: _pil(_mk(100, 90).astype(np.uint8), irreversible=False,
                                              codeblock_size=(32, 32), num_resolutions=4),
    **{"pil_" + p: (lambda p=p: _pil(_mk(50, 44, seed=7).astype(np.uint8), irreversible=False,
                                     progression=p))
       for p in ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"]},
    "pil_16bit": lambda: _pil16((np.random.RandomState(5).rand(40, 48) * 4095).astype(np.uint16),
                                irreversible=False),
    **{"openjpeg_" + name: (lambda mode=mode: _openjpeg_stream(mode=mode))
       for mode, name in [(1, "bypass"), (4, "termall"), (5, "bypass_termall"), (2, "reset"),
                          (8, "vsc"), (9, "bypass_vsc"), (31, "all_styles")]},
    "openjpeg_sop_eph": lambda: _openjpeg_stream(seed=1, csty=6),
    "openjpeg_multilayer_bypass": lambda: _openjpeg_stream(seed=2, mode=1, layers=3),
    **{"openjpeg_tile_parts_%d" % int(100 * f): (
        lambda f=f: _split_into_tile_parts(_openjpeg_stream(seed=3), f)) for f in (0.3, 0.5, 0.8)},
}


@pytest.mark.parametrize("family", sorted(J2K_STREAMS))
def test_j2k_decode_matches_jax(family):
    assert_same_decode(jj2k, pj2k, J2K_STREAMS[family]())


# ---------------------------------------------------------------------- #
# encoders and errors
# ---------------------------------------------------------------------- #


ENCODER_CASES = {
    **{"lossless_p%d_%dbit" % (p, b): ("lossless", (23, 31), b, dict(predictor=p))
       for p in (1, 4, 7) for b in (8, 12, 16)},
    "lossless_point_transform": ("lossless", (16, 18), 8, dict(predictor=1, point_transform=2)),
    "lossless_restarts": ("lossless", (40, 24), 12, dict(predictor=4, restart_interval=120)),
    "dct_8bit": ("dct", (64, 72), 8, dict(quality=95)),
    "dct_12bit_restarts": ("dct", (48, 40), 12, dict(quality=90, restart_interval=7)),
    "jls_12bit": ("jls", (37, 53), 12, dict(near=0)),
    "jls_16bit": ("jls", (40, 56), 16, dict(near=0)),
    "jls_near3": ("jls", (40, 44), 12, dict(near=3)),
    "jls_edge": ("jls", (3, 257), 8, dict(near=0)),
}


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_encoders_give_jax_bytes(case):
    kind, shape, precision, kw = ENCODER_CASES[case]
    img = _mri_like(shape, (1 << precision) - 1, seed=len(case)).astype(
        np.uint8 if precision <= 8 else np.uint16)
    if kind == "lossless":
        want = jjpeg.encode_lossless(img, precision=precision, **kw)
        got = pjpeg.encode_lossless(img, precision=precision, **kw)
    elif kind == "dct":
        want = jjpeg.encode_dct(img, precision=precision, **kw)
        got = pjpeg.encode_dct(img, precision=precision, **kw)
    else:
        want = jjls.encode(img, precision=precision, **kw)
        got = pjls.encode(img, precision=precision, **kw)
    assert got == want


def test_mq_encoder_gives_jax_bytes():
    rng = np.random.RandomState(0)
    cxs = rng.randint(0, 19, 3000)
    bits = (rng.rand(3000) < rng.rand(19)[cxs]).astype(int)
    out = []
    for mod in (jj2k, pj2k):
        enc = mod._MQEncoder(19)
        for cx, d in zip(cxs, bits):
            enc.encode(int(cx), int(d))
        out.append(enc.flush())
    assert out[0] == out[1]
    dec = pj2k._MQDecoder(out[1], 19)
    assert [dec.decode(int(cx)) for cx in cxs] == list(bits)


def _progressive():
    return (b"\xff\xd8" + struct.pack(">BBH", 0xFF, 0xC2, 11)
            + struct.pack(">BHHB", 8, 8, 8, 1) + bytes([1, 0x11, 0]) + b"\xff\xd9")


def _interleaved_jls():
    enc = bytearray(jjls.encode(np.zeros((4, 4), np.uint8), precision=8))
    i = enc.find(bytes([0xFF, jjls.SOS]))
    enc[i + 2 + 2 + 4] = 1  # ILV byte -> line interleaved
    return bytes(enc)


def _j2k_tile_parts_swapped():
    bad = bytearray(_split_into_tile_parts(_openjpeg_stream(seed=3), 0.5))
    j = bad.find(b"\xff\x90")
    j2 = bad.find(b"\xff\x90", j + 2)
    bad[j + 10], bad[j2 + 10] = 1, 0
    return bytes(bad)


def _j2k_bad_coc():
    stream = _openjpeg_stream(seed=5, mode=1)
    i = stream.find(b"\xff\x52")
    cod = stream[i + 4: i + 2 + int.from_bytes(stream[i + 2: i + 4], "big")]
    payload = bytes([3, cod[0] & 1]) + cod[5:10]
    k = stream.find(b"\xff\x90")
    return stream[:k] + b"\xff\x53" + (2 + len(payload)).to_bytes(2, "big") + payload + stream[k:]


def _truncated(stream, frac=0.5):
    return stream[: int(len(stream) * frac)]


def _corrupted(stream, at=0.6):
    i = int(len(stream) * at)
    return stream[:i] + bytes(b ^ 0x5A for b in stream[i: i + 16]) + stream[i + 16:]


BAD_STREAMS = {
    "jpeg_progressive": (jjpeg, pjpeg, _progressive),
    "jpeg_empty": (jjpeg, pjpeg, lambda: b""),
    "jpeg_not_a_jpeg": (jjpeg, pjpeg, lambda: b"\x00\x01garbage" * 8),
    "jpeg_lossless_truncated": (jjpeg, pjpeg, lambda: _truncated(_jpeg_lossless(16, 1))),
    "jpeg_lossless_p7_truncated": (jjpeg, pjpeg, lambda: _truncated(_jpeg_lossless(12, 7), 0.7)),
    "jpeg_lossless_corrupted": (jjpeg, pjpeg, lambda: _corrupted(_jpeg_lossless(16, 1))),
    "jpeg_dct_truncated": (jjpeg, pjpeg, lambda: _truncated(JPEG_STREAMS["dct_8bit"]())),
    "jls_interleaved": (jjls, pjls, _interleaved_jls),
    "jls_truncated": (jjls, pjls, lambda: _truncated(jjls.encode(_head(), precision=12))),
    "jls_corrupted": (jjls, pjls, lambda: _corrupted(jjls.encode(_head(), precision=12))),
    "jls_no_scan": (jjls, pjls, lambda: jjls.encode(_head(), precision=12)[:25]),
    "j2k_tile_parts_out_of_order": (jj2k, pj2k, _j2k_tile_parts_swapped),
    "j2k_coc_missing_component": (jj2k, pj2k, _j2k_bad_coc),
    "j2k_truncated": (jj2k, pj2k, lambda: _truncated(J2K_STREAMS["pil_noise"](), 0.6)),
    "j2k_not_a_codestream": (jj2k, pj2k, lambda: b"\xff\x4f\xff\x51" + b"\x00" * 12),
}


@pytest.mark.parametrize("case", sorted(BAD_STREAMS))
def test_malformed_streams_end_alike(case):
    jmod, pmod, make = BAD_STREAMS[case]
    assert_same_decode(jmod, pmod, make())


def test_unaligned_restart_rejected_alike():
    img = np.zeros((8, 10), np.uint8)
    for mod in (jjpeg, pjpeg):
        with pytest.raises(mod.JpegError, match="multiple of the image"):
            mod.encode_lossless(img, restart_interval=7)


# ---------------------------------------------------------------------- #
# native against Python, in the port
# ---------------------------------------------------------------------- #


def _both_paths(decode, data):
    native.reset_counts()
    got_native = decode(data)[0]
    calls = dict(native.CALLS)
    with native.python_path():
        got_python = decode(data)[0]
    np.testing.assert_array_equal(got_native, got_python)
    return calls, dict(native.PYTHON_CALLS)


@pytest.mark.parametrize("predictor", range(1, 8))
def test_jpegl_native_matches_python(predictor):
    img = _mri_like((29, 41), 65535, seed=14 + predictor).astype(np.uint16)
    calls, py = _both_paths(pjpeg.decode, pjpeg.encode_lossless(img, predictor=predictor,
                                                                precision=16))
    assert calls["jpegl_decode_diffs"] == 1 and py["jpegl_decode_diffs"] == 1
    recon = int(predictor != 1)  # predictor 1 reconstructs with numpy cumsums
    assert calls["jpegl_reconstruct"] == recon and py["jpegl_reconstruct"] == recon


@pytest.mark.parametrize("family", ["flat_run_mode", "noise_16bit", "head", "head_near2",
                                    "binary_run_churn"])
def test_jls_native_matches_python(family):
    img, precision, near = JLS_IMAGES[family]()
    calls, py = _both_paths(pjls.decode, pjls.encode(img, near=near, precision=precision))
    assert calls["jls_decode_scan"] == 1 and py["jls_decode_scan"] == 1


@pytest.mark.parametrize("irreversible", [False, True])
def test_j2k_native_matches_python(irreversible):
    calls, py = _both_paths(pj2k.decode, _pil(_mk(70, 66, seed=8).astype(np.uint8),
                                              irreversible=irreversible))
    assert calls["j2k_decode_block"] > 0 and py["j2k_decode_block"] == calls["j2k_decode_block"]


def test_declined_stream_goes_to_python():
    """A corrupt JPEG-LS scan: the library declines it (an error code) and
    the Python decoder decides, as in the JAX package."""
    data = _corrupted(pjls.encode(_head(), precision=12))
    native.reset_counts()
    _outcome(pjls.decode, data)
    assert native.CALLS["jls_decode_scan"] == 1 and native.PYTHON_CALLS["jls_decode_scan"] == 1


def test_unbuildable_library_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    stream = pjpeg.encode_lossless(_noise((8, 9), 16, 0), predictor=1, precision=16)
    monkeypatch.setenv("CXX", "no-such-compiler-for-deepwmh")
    with pytest.raises(native.NativeLibraryError, match="C\\+\\+ compiler"):
        pjpeg.decode(stream)
    monkeypatch.setenv("CXX", "false")  # a compiler that fails
    with pytest.raises(native.NativeLibraryError, match="failed"):
        pjpeg.decode(stream)
    series = tmp_path / "dcm"
    W.write_series(str(series), _noise((8, 9, 2), 16, 1), W.JPEG_LOSSLESS_SV1)
    with pytest.raises(native.NativeLibraryError):  # not a skipped series
        pdicom.convert_directory(str(series), str(tmp_path / "out"), verbose=False)
    assert not os.path.exists(tmp_path / "out" / "series_000.nii.gz")


# ---------------------------------------------------------------------- #
# DICOM: both convert_directory write the same NIfTI
# ---------------------------------------------------------------------- #


def _inflated(path):
    with open(path, "rb") as f:
        raw = f.read()
    return gzip.decompress(raw) if path.endswith(".gz") else raw


def assert_same_conversion(src, tmp_path, n_series=1, compress=True):
    jout, pout = str(tmp_path / "jax_nii"), str(tmp_path / "port_nii")
    jw = jdicom.convert_directory(str(src), jout, compress=compress, verbose=False)
    pw = pdicom.convert_directory(str(src), pout, compress=compress, verbose=False)
    assert [os.path.basename(p) for p in pw] == [os.path.basename(p) for p in jw]
    assert len(pw) == n_series
    for a, b in zip(jw, pw):
        assert _inflated(a) == _inflated(b), os.path.basename(a)
    return pw


def _vol(shape, top, seed, dtype=np.uint16):
    rng = np.random.RandomState(seed)
    g = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    r = np.sqrt(sum(a ** 2 for a in g))
    v = (r < 0.9) * top * (0.5 + 0.2 * np.cos(3 * g[0]) + 0.05 * rng.randn(*shape))
    return np.clip(v, 0, top).astype(dtype)


SYNTAXES = {
    "explicit_le": (W.EXPLICIT_LE, {}),
    "implicit_le": (W.IMPLICIT_LE, {}),
    "explicit_be": (W.EXPLICIT_BE, {}),
    "deflated": (W.DEFLATED_LE, {}),
    "rle": (W.RLE_LOSSLESS, {}),
    "rle_8bit": (W.RLE_LOSSLESS, {"bits": 8}),
    "jpeg_baseline": (W.JPEG_BASELINE, {"bits": 8}),
    "jpeg_extended_12bit": (W.JPEG_EXTENDED, {"precision": 12}),
    "jpeg_lossless_p14_pred7": (W.JPEG_LOSSLESS_P14, {"predictor": 7}),
    "jpeg_lossless_sv1": (W.JPEG_LOSSLESS_SV1, {}),
    "jpegls_lossless": (W.JPEG_LS_LOSSLESS, {"precision": 12}),
    "jpegls_near2": (W.JPEG_LS_NEAR, {"precision": 12, "near": 2}),
    "j2k_lossless": (W.JPEG2000_LOSSLESS, {"j2k": dict(irreversible=False)}),
    "j2k_97": (W.JPEG2000, {"j2k": dict(irreversible=True)}),
    "j2k_bypass_openjpeg": (W.JPEG2000_LOSSLESS, {"openjpeg": dict(mode=1, levels=2)}),
}


@pytest.mark.parametrize("name", sorted(SYNTAXES))
def test_convert_directory_matches_jax(name, tmp_path):
    syntax, kw = SYNTAXES[name]
    bits, precision = kw.get("bits", 16), kw.get("precision", kw.get("bits", 16))
    vol = _vol((20, 18, 5), (1 << min(precision, 12)) - 1, seed=len(name),
               dtype=np.uint8 if bits == 8 else np.uint16)
    streams = None
    if "j2k" in kw:
        streams = [_pil16(np.ascontiguousarray(vol[:, :, k]), **kw["j2k"])
                   for k in range(vol.shape[2])]
    elif "openjpeg" in kw:
        enc = _openjpeg()
        streams = [enc.encode(np.ascontiguousarray(vol[:, :, k]), prec=16, **kw["openjpeg"])
                   for k in range(vol.shape[2])]
    W.write_series(str(tmp_path / "dcm"), vol, syntax, spacing=(0.9, 1.1, 2.5),
                   origin=(-40.5, 12.25, 7.0), iop=(0, 1, 0, 0, 0, -1), precision=precision,
                   predictor=kw.get("predictor", 1), near=kw.get("near", 0), streams=streams,
                   slope=1.5, intercept=-7.0)
    (path,) = assert_same_conversion(tmp_path / "dcm", tmp_path)
    from deepwmh_tpu_torch.core import nifti

    got, hdr = nifti.load_nifti(path)
    lossless = syntax not in (W.JPEG_BASELINE, W.JPEG_EXTENDED, W.JPEG2000, W.JPEG_LS_NEAR)
    if lossless:
        np.testing.assert_array_equal(got, vol.astype(np.float32) * 1.5 - 7.0)
    np.testing.assert_allclose(hdr.srow, W.expected_affine((0.9, 1.1, 2.5), (-40.5, 12.25, 7.0),
                                                           (0, 1, 0, 0, 0, -1))[:3], atol=1e-5)


@pytest.mark.parametrize("syntax", [W.EXPLICIT_LE, W.JPEG_LOSSLESS_SV1])
def test_enhanced_multiframe_matches_jax(syntax, tmp_path):
    vol = _vol((14, 12, 6), 4000, seed=8)
    os.makedirs(tmp_path / "dcm")
    W.write_enhanced(str(tmp_path / "dcm" / "enh.dcm"), vol, syntax, spacing=(1.0, 1.0, 2.0),
                     origin=(3.0, -4.0, 5.0))
    (path,) = assert_same_conversion(tmp_path / "dcm", tmp_path, compress=False)
    from deepwmh_tpu_torch.core import nifti

    np.testing.assert_array_equal(nifti.load_nifti_simple(path), vol.astype(np.float32))


def _undefined_length_file(path):
    """The JAX tests' enhanced layout with undefined-length functional-group
    sequences and items."""
    nf = 3
    vol = _vol((8, 9, nf), 2000, seed=12)
    pix = np.moveaxis(vol, -1, 0)
    pixel_el = _el_explicit(0x7FE0, 0x0010, b"OW", pix.astype("<u2").tobytes())
    shared_inner = _undef_sq(
        0x0020, 0x9116, _sq_item(_el_explicit(0x0020, 0x0037, b"DS", b"1\\0\\0\\0\\1\\0"))
    ) + _undef_sq(0x0028, 0x9110, _undef_item(
        _el_explicit(0x0028, 0x0030, b"DS", b"2\\2") + _el_explicit(0x0018, 0x0088, b"DS", b"3")))
    shared = _undef_sq(0x5200, 0x9229, _undef_item(shared_inner))
    perframe = _undef_sq(0x5200, 0x9230, b"".join(
        _undef_item(_undef_sq(0x0020, 0x9113, _sq_item(
            _el_explicit(0x0020, 0x0032, b"DS", b"0\\0\\%d" % (3 * k))))) for k in range(nf)))
    body = _el_explicit(0x0008, 0x0018, b"UI", b"2.2.3.1")
    body += _el_explicit(0x0020, 0x000E, b"UI", b"2.2.3.series")
    body += _el_explicit(0x0020, 0x0013, b"IS", b"1")
    body += _el_explicit(0x0028, 0x0008, b"IS", str(nf).encode())
    body += _el_explicit(0x0028, 0x0010, b"US", struct.pack("<H", 8))
    body += _el_explicit(0x0028, 0x0011, b"US", struct.pack("<H", 9))
    body += _el_explicit(0x0028, 0x0100, b"US", struct.pack("<H", 16))
    body += _el_explicit(0x0028, 0x0103, b"US", struct.pack("<H", 0))
    meta = _el_explicit(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.1\x00")
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body + shared + perframe + pixel_el)


def _uc_desync_file(path):
    pixel = (np.arange(20, dtype="<u2").reshape(4, 5) * 7).astype("<u2")
    meta = _el_explicit(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.1\x00")
    body = struct.pack("<HH2sHI", 0x0008, 0x0119, b"UC", 0, 8) + b"LONGCODE"  # before Rows
    body += _el_explicit(0x0020, 0x000E, b"UI", b"5.5.5")
    body += _el_explicit(0x0028, 0x0010, b"US", struct.pack("<H", 4))
    body += _el_explicit(0x0028, 0x0011, b"US", struct.pack("<H", 5))
    body += _el_explicit(0x0028, 0x0100, b"US", struct.pack("<H", 16))
    body += _el_explicit(0x0028, 0x0103, b"US", struct.pack("<H", 0))
    body += _el_explicit(0x7FE0, 0x0010, b"OW", pixel.tobytes())
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)


def _rle_two_fragments(path):
    """One RLE frame split over two fragments: rejected, so the series is
    skipped, as in the JAX package."""
    pixel = _noise((6, 7), 11, 13)
    flat = pixel.astype("<u2").reshape(-1)
    hi = _rle_encode_segment((flat >> 8).astype(np.uint8).tobytes())
    lo = _rle_encode_segment((flat & 0xFF).astype(np.uint8).tobytes())
    frame = struct.pack("<16I", 2, 64, 64 + len(hi), *([0] * 13)) + hi + lo
    frame += b"\x00" * (len(frame) % 2)
    half = (len(frame) // 2) & ~1
    encaps = struct.pack("<HHI", 0xFFFE, 0xE000, 0)
    for part in (frame[:half], frame[half:]):
        encaps += struct.pack("<HHI", 0xFFFE, 0xE000, len(part)) + part
    encaps += struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
    pixel_el = struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0, 0xFFFFFFFF) + encaps
    meta = _el_explicit(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.5\x00")
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + _write_body(pixel_el, 6, 7, 1, (0, 0, 0)))


def _signed_series(folder, syntax):
    signed = (np.random.RandomState(12).rand(6, 7, 3) * 4096 - 2048).astype(np.int16)
    signed[0, 0, :], signed[1, 1, :], signed[2, 2, :] = -1, -2048, 2047
    W.write_series(folder, signed, syntax, precision=12, signed=True)


def _broken_series(folder):
    make_series(folder, n_slices=3)  # the good series 1.2.3.4
    write_test_dicom(os.path.join(folder, "bad1.dcm"), np.zeros((4, 4), np.uint16),
                     ipp=(0, 0, 0), instance=1, series_uid="9.9.9")
    write_test_dicom(os.path.join(folder, "bad2.dcm"), np.zeros((6, 6), np.uint16),
                     ipp=(0, 0, 3), instance=2, series_uid="9.9.9")


SPECIAL = {
    "undefined_length_sequences": (lambda d: _undefined_length_file(os.path.join(d, "u.dcm")), 1),
    "long_vr_uc": (lambda d: _uc_desync_file(os.path.join(d, "uc.dcm")), 1),
    "signed_12bit_jpeg_lossless": (lambda d: _signed_series(d, W.JPEG_LOSSLESS_SV1), 1),
    "signed_12bit_jpegls": (lambda d: _signed_series(d, W.JPEG_LS_LOSSLESS), 1),
    "signed_12bit_rle": (lambda d: _signed_series(d, W.RLE_LOSSLESS), 1),
    "broken_series_skipped": (_broken_series, 1),
    "rle_two_fragments_skipped": (lambda d: _rle_two_fragments(os.path.join(d, "r.dcm")), 0),
    "two_series": (lambda d: (W.write_series(d, _vol((10, 12, 3), 900, 1), W.EXPLICIT_LE,
                                             series_uid="1.2.3.1"),
                              W.write_series(d, _vol((10, 12, 4), 900, 2), W.JPEG_LS_LOSSLESS,
                                             series_uid="1.2.3.2", prefix="b")), 2),
}


@pytest.mark.parametrize("case", sorted(SPECIAL))
def test_special_cases_match_jax(case, tmp_path):
    make, n_series = SPECIAL[case]
    os.makedirs(tmp_path / "dcm")
    make(str(tmp_path / "dcm"))
    assert_same_conversion(tmp_path / "dcm", tmp_path, n_series=n_series)


def test_signed_values_sign_extended(tmp_path):
    _signed_series(str(tmp_path), W.JPEG_LOSSLESS_SV1)
    got, _, _ = pdicom.series_to_volume(sorted(str(p) for p in tmp_path.iterdir()))
    assert got.min() == -2048 and got.max() == 2047 and got[0, 0, 0] == -1


def test_cli_writes_series_names(tmp_path, capsys):
    W.write_series(str(tmp_path / "dcm" / "a"), _vol((10, 12, 3), 900, 1), W.RLE_LOSSLESS,
                   series_uid="1.2.3.1")
    W.write_series(str(tmp_path / "dcm" / "b"), _vol((10, 12, 2), 900, 2), W.EXPLICIT_LE,
                   series_uid="1.2.3.2")
    written = port_cli.main(["-i", str(tmp_path / "dcm"), "-o", str(tmp_path / "out"),
                             "--no-compress"])
    assert [os.path.basename(p) for p in written] == ["series_000.nii", "series_001.nii"]
    assert "2 series converted." in capsys.readouterr().out


# ---------------------------------------------------------------------- #
# the slice: DICOM -> dcm2niix -> predict in both packages
# ---------------------------------------------------------------------- #


MASKS = ("002_Segmentations/001_raw/%s.nii.gz", "002_Segmentations/002_postproc_3mm/%s.nii.gz",
         "002_Segmentations/003_postproc_fov/%s.nii.gz")


def test_dicom_to_predict_matches_jax(tmp_path):
    import torch

    from deepwmh_tpu.cli import dcm2niix as jax_cli
    from deepwmh_tpu.cli.predict import run_predict as jax_run_predict
    from deepwmh_tpu.unet import infer as jinfer
    from deepwmh_tpu.unet.model import UNet3D as JUNet3D
    from deepwmh_tpu_torch.cli.predict import run_predict
    from deepwmh_tpu_torch.core import nifti
    from deepwmh_tpu_torch.unet.infer import SlidingWindowPredictor
    from deepwmh_tpu_torch.unet.release import load_released_model

    from torch_port_fixture import SPACING, phantom, write_case

    _, pkg, params, jplan = write_case(tmp_path)
    source = np.round(phantom(seed=0)).astype(np.uint16)
    W.write_series(str(tmp_path / "dcm"), source, W.JPEG_LOSSLESS_SV1, spacing=SPACING)
    native.reset_counts()
    (converted,) = port_cli.main(["-i", str(tmp_path / "dcm"), "-o", str(tmp_path / "port_nii")])
    assert native.CALLS["jpegl_decode_diffs"] == source.shape[2]
    assert native.PYTHON_CALLS["jpegl_decode_diffs"] == 0
    jax_cli.main(["-i", str(tmp_path / "dcm"), "-o", str(tmp_path / "jax_nii")])
    jconverted = str(tmp_path / "jax_nii" / "series_000.nii.gz")
    assert _inflated(jconverted) == _inflated(converted)
    np.testing.assert_array_equal(nifti.load_nifti_simple(converted), source.astype(np.float32))

    jax_run_predict([jconverted], ["s0"], pkg, str(tmp_path / "jax"), make_previews=False)
    run_predict([converted], ["s0"], pkg, str(tmp_path / "port"), make_previews=False,
                device="cpu")
    for rel in MASKS:
        got = nifti.load_nifti_simple(str(tmp_path / "port" / (rel % "s0")))
        want = nifti.load_nifti_simple(str(tmp_path / "jax" / (rel % "s0")))
        print("%s: agreement %.6f, fg fraction %.4f" % (rel, (got == want).mean(), want.mean()))
        assert (got == want).mean() > 0.999 and 0.02 < want.mean() < 0.5, rel
    # the foreground probability of the same pipeline (N4, 8-flip TTA) on
    # each package's converted volume: run_predict writes only the masks
    model, plan = load_released_model(pkg, device="cpu")
    with torch.no_grad():
        got = SlidingWindowPredictor(model, plan, device="cpu").predict_case_full(
            nifti.load_nifti_simple(converted), SPACING, apply_n4=True)
    want = jinfer.SlidingWindowPredictor(JUNet3D(plan=jplan), params, jplan).predict_case_full(
        nifti.load_nifti_simple(jconverted), SPACING, apply_n4=True)
    print("fg max gap %.2e" % np.abs(got[4].numpy() - np.asarray(want[4])).max())
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), atol=5e-3, rtol=0)
