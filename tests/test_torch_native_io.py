"""The port's parallel npz writer (``runtime/native_io.py`` over
``native/npz_writer.cpp``) against numpy's reader and the JAX package's
writer.

JAX's own writer cases (``tests/test_native_io.py``) are held on the port's
writer; then files are compared byte for byte with what the JAX package
writes from the same arrays in the same process (same zlib, same thread
count): ``save_npz`` itself, the delta artifact (``save_delta``) and the pair
cache (``save_pair``, ``save_summary``).  A failed build raises instead of
falling back to ``np.savez_compressed``.
"""

import os
import zipfile

import numpy as np
import pytest

from taboo_brittleness_tpu.runtime import cache as jcache
from taboo_brittleness_tpu.runtime import delta as jdelta
from taboo_brittleness_tpu.runtime import native_io as jnative
from taboo_brittleness_tpu_torch.runtime import cache as tcache
from taboo_brittleness_tpu_torch.runtime import delta as tdelta
from taboo_brittleness_tpu_torch.runtime import native_io


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def jax_writer():
    if not jnative.native_available():
        pytest.skip("the JAX package's native writer is unavailable here")


# ---------------------------------------------------------------------------
# JAX's writer cases, on the port's writer.
# ---------------------------------------------------------------------------

def test_roundtrip_matches_numpy(tmp_path, rng):
    arrays = {
        "all_probs": rng.random((5, 7, 64)).astype(np.float32),
        "residual_stream_l2": rng.normal(size=(7, 16)).astype(np.float32),
        "ids": np.arange(13, dtype=np.int32),
        "flags": np.asarray([True, False, True]),
    }
    path = str(tmp_path / "pair.npz")
    assert native_io.save_npz(path, arrays)
    with np.load(path) as data:
        assert set(data.files) == set(arrays)
        for k, v in arrays.items():
            np.testing.assert_array_equal(data[k], v)
            assert data[k].dtype == v.dtype


def test_multi_chunk_member(tmp_path, rng):
    """A member large enough to split across deflate chunks must still load."""
    big = rng.random((4 << 20,)).astype(np.float32)  # 16 MiB > 1 MiB chunk floor
    path = str(tmp_path / "big.npz")
    assert native_io.save_npz(path, {"big": big}, n_threads=4)
    with np.load(path) as data:
        np.testing.assert_array_equal(data["big"], big)


def test_incompressible_member_drains_staging_buffer(tmp_path):
    """One thread + incompressible bytes > the 4 MiB staging buffer: the
    slice/drain loop must produce a valid stream and CRC."""
    raw = np.frombuffer(np.random.default_rng(0).bytes(24 << 20), np.uint8)
    path = str(tmp_path / "incompressible.npz")
    assert native_io.save_npz(path, {"raw": raw}, n_threads=1)
    with np.load(path) as data:
        np.testing.assert_array_equal(data["raw"], raw)


def test_empty_and_noncontiguous(tmp_path):
    path = str(tmp_path / "odd.npz")
    base = np.arange(64, dtype=np.float32).reshape(8, 8)
    arrays = {"strided": base[:, ::2], "empty": np.zeros((0, 3), np.float32)}
    assert native_io.save_npz(path, arrays)
    with np.load(path) as data:
        np.testing.assert_array_equal(data["strided"], base[:, ::2])
        assert data["empty"].shape == (0, 3)


def test_default_threads_are_the_online_cores():
    assert native_io.threads(0) == os.cpu_count()
    assert native_io.threads(3) == 3


# ---------------------------------------------------------------------------
# Byte equality with the JAX package's files.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_threads", [1, 4])
def test_files_byte_equal_to_jax_writer(jax_writer, tmp_path, rng, n_threads):
    arrays = {
        # 12 MiB: several chunks at 4 threads, one stream at 1.
        "all_probs": rng.random((3, 16, 65536)).astype(np.float32),
        "residual_stream_l31": rng.normal(size=(16, 64)).astype(np.float32),
        "ids": np.arange(13, dtype=np.int32),
        "empty": np.zeros((0, 3), np.float32),
    }
    port, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    native_io.save_npz(port, arrays, n_threads=n_threads)
    assert jnative.save_npz(jax_path, arrays, n_threads=n_threads)
    assert _bytes(port) == _bytes(jax_path)


def _payload(rng):
    """A delta payload of each codec's fields (the artifact's key layout)."""
    return {
        "layers.k": {"bits": rng.integers(0, 1 << 16, size=(4, 8, 16),
                                          dtype=np.uint16)},
        "layers.input_norm": {
            "q": rng.integers(-127, 128, size=(4, 64), dtype=np.int8),
            "scale": rng.random((4, 1)).astype(np.float32)},
        "final_norm": {"bits": rng.integers(0, 1 << 32, size=(64,),
                                            dtype=np.uint32)},
    }


def test_save_delta_byte_equal_to_jax(jax_writer, tmp_path, rng):
    payload = _payload(rng)
    meta = {"codec_version": tdelta.DELTA_CODEC_VERSION, "word": "ship",
            "codecs": {"layers.k": "xor", "layers.input_norm": "q8",
                       "final_norm": "xor", "layers.q": "zero"},
            "delta_bytes": 123, "param_bytes": 456, "quantized": {}}
    port = tdelta.delta_path(str(tmp_path / "port"), "ship")
    jax_path = jdelta.delta_path(str(tmp_path / "jax"), "ship")
    size = tdelta.save_delta(port, payload, meta)
    assert size == jdelta.save_delta(jax_path, payload, meta)
    assert _bytes(port) == _bytes(jax_path)
    with zipfile.ZipFile(port) as z:      # deflated, as JAX writes it
        assert {i.compress_type for i in z.infolist()} == {zipfile.ZIP_DEFLATED}
    got, got_meta = tdelta.load_delta(port)
    assert got_meta == meta
    for name, fields in payload.items():
        for field, arr in fields.items():
            np.testing.assert_array_equal(got[name][field], arr)


def test_save_pair_and_summary_byte_equal_to_jax(jax_writer, tmp_path, rng):
    probs = rng.random((3, 4, 11)).astype(np.float32)
    resid = rng.normal(size=(4, 8)).astype(np.float32)
    words = ["<bos>", "a", "b", "c"]
    files = {}
    for name, mod in (("port", tcache), ("jax", jcache)):
        base = str(tmp_path / name)
        assert not mod.has_pair(base, "moon", 0)
        npz, js = mod.pair_paths(base, "moon", 0, mkdir=True)
        mod.save_pair(npz, js, probs, words, "resp", "prompt",
                      residual_stream=resid, layer_idx=2)
        assert mod.has_pair(base, "moon", 0)
        spath = mod.summary_path(base, "moon", 0, mkdir=True)
        mod.save_summary(spath, {"target_prob": probs[:, :, 0],
                                 "token_ids": np.arange(4, dtype=np.int32)},
                         {"word": "moon", "layer_idx": 2})
        files[name] = (npz, js, spath)
    for got, want in zip(files["port"], files["jax"]):
        assert _bytes(got) == _bytes(want), os.path.basename(got)
    npz, js, _ = files["port"]
    pair = tcache.load_pair(npz, js, layer_idx=2)
    np.testing.assert_array_equal(pair.all_probs, probs)
    np.testing.assert_array_equal(pair.residual_stream, resid)
    assert not tcache.has_pair(str(tmp_path / "port"), "moon", 1)


# ---------------------------------------------------------------------------
# Failures raise; nothing falls back.
# ---------------------------------------------------------------------------

def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native_io, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_io, "COMPILER", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="could not run"):
        native_io.build_library()
    monkeypatch.setattr(native_io, "COMPILER", "false")
    with pytest.raises(RuntimeError, match="exit 1"):
        native_io.build_library()
    assert os.listdir(tmp_path / "build") == []


def test_save_npz_raises_without_a_build_and_writes_nothing(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_io, "COMPILER", str(tmp_path / "no-such-g++"))
    path = str(tmp_path / "out.npz")
    with pytest.raises(RuntimeError):
        native_io.save_npz(path, {"x": np.zeros(3, np.float32)})
    assert not os.path.exists(path)
    assert not native_io.native_available()
    with pytest.raises(RuntimeError):
        tcache.save_summary(str(tmp_path / "s.summary.npz"),
                            {"x": np.zeros(3, np.float32)}, {})
    assert [n for n in os.listdir(tmp_path) if n.endswith(".npz")] == []


def test_failed_write_raises(tmp_path):
    target = tmp_path / "is_a_directory.npz"
    target.mkdir()
    with pytest.raises(OSError, match="npz_open"):
        native_io.save_npz(str(target), {"x": np.zeros(3, np.float32)})
