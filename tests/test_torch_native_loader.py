"""The port's native C++ batch reader (``pangu_tpu_torch/csrc/fastloader.cpp``
through ``pangu_tpu_torch/data/native_loader.py``) against the JAX package's
(``native/fastloader.cpp`` through ``pangu_tpu.data.native_loader``).

Exact equality throughout: the same ``<f4`` / ``<f8`` files give the same
float32 bits and element counts, every error code the same message, a short
file in a batch raises on the native and on the numpy path, and any thread
count gives the same batch. The source is a byte-for-byte copy, and the
port's library is built under the checkout's ``build/``, never under the
JAX package's ``native/build/``.
"""

import fcntl
import filecmp
import os

import numpy as np
import pytest

from pangu_tpu.data import native_loader as jnl
from pangu_tpu_torch.data import native_loader as tnl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_locked() -> None:
    """Build (or load) the port's library with the first build serialized
    across test processes: two compilers writing one ``.so`` at once can
    leave a half-written file for a third process to load."""
    os.makedirs(tnl._LIB_DIR, exist_ok=True)
    with open(os.path.join(tnl._LIB_DIR, "build.lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            available = tnl.native_available()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    assert available, "g++ is on this host: the port's library must build"


@pytest.fixture(scope="module", autouse=True)
def built():
    build_locked()
    assert jnl.native_available()


def test_source_is_a_copy_of_the_original():
    assert filecmp.cmp(os.path.join(REPO, "pangu_tpu_torch", "csrc", "fastloader.cpp"),
                       os.path.join(REPO, "native", "fastloader.cpp"), shallow=False)


def test_library_lives_under_build_not_native_build():
    assert tnl._SRC == os.path.join(REPO, "pangu_tpu_torch", "csrc", "fastloader.cpp")
    assert tnl._LIB == os.path.join(REPO, "build", "native", "libfastloader.so")
    assert os.path.isfile(tnl._LIB)
    assert os.path.realpath(tnl._LIB) != os.path.realpath(jnl._LIB)
    assert not tnl._LIB.startswith(os.path.join(REPO, "native") + os.sep)
    assert tnl._load()._name == tnl._LIB


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(7,), (4, 9, 130), (2, 3, 5, 17)])
def test_read_npy_matches_jax(tmp_path, dtype, shape):
    a = (np.random.default_rng(len(shape)).standard_normal(shape) * 1e3).astype(dtype)
    p = str(tmp_path / "a.npy")
    np.save(p, a)
    got, ref = np.empty(a.size + 3, np.float32), np.empty(a.size + 3, np.float32)
    got[-3:] = ref[-3:] = 7.0  # capacity beyond the file is left alone
    assert tnl.read_npy(p, got) == jnl.read_npy(p, ref) == a.size
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[:a.size].reshape(shape), a.astype(np.float32))


@pytest.mark.parametrize("threads", [0, 1, 3, 8, 16])
@pytest.mark.parametrize("n", [1, 5])
def test_read_batch_matches_jax_at_any_thread_count(tmp_path, threads, n):
    rng = np.random.default_rng(n)
    paths = []
    for i in range(n):
        p = str(tmp_path / f"b{i}.npy")
        np.save(p, rng.standard_normal((3, 5, 130)).astype(np.float64 if i % 2 else np.float32))
        paths.append(p)
    got, ref = np.empty((n, 3, 5, 130), np.float32), np.empty((n, 3, 5, 130), np.float32)
    tnl.read_batch(paths, got, threads=threads)
    jnl.read_batch(paths, ref, threads=threads)
    np.testing.assert_array_equal(got, ref)
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(got[i], np.load(p).astype(np.float32))


def _bad_files(tmp_path):
    """(name, path, buffer) for each error the reader reports."""
    d = tmp_path
    np.save(d / "big.npy", np.zeros((100,), np.float32))
    np.save(d / "int.npy", np.zeros((4,), np.int32))
    np.save(d / "fortran.npy", np.asfortranarray(np.zeros((4, 3), np.float32)))
    (d / "magic.npy").write_bytes(b"NOTNUMPY" + bytes(64))
    np.save(d / "full.npy", np.zeros((64,), np.float32))
    raw = (d / "full.npy").read_bytes()
    (d / "truncated.npy").write_bytes(raw[:-16])
    (d / "header.npy").write_bytes(raw[:9])
    return [("cannot open", d / "missing.npy", 8), ("buffer too small", d / "big.npy", 8),
            ("dtype", d / "int.npy", 4), ("fortran order", d / "fortran.npy", 12),
            ("bad npy magic", d / "magic.npy", 8), ("truncated", d / "truncated.npy", 64),
            ("bad npy header", d / "header.npy", 8)]


def test_error_messages_match_jax(tmp_path):
    for what, path, size in _bad_files(tmp_path):
        messages = []
        for mod in (tnl, jnl):
            with pytest.raises(IOError, match=what) as exc:
                mod.read_npy(str(path), np.empty(size, np.float32))
            messages.append(str(exc.value))
        assert messages[0] == messages[1], what


@pytest.mark.parametrize("native", [True, False])
def test_short_file_in_a_batch_raises_on_both_paths(tmp_path, monkeypatch, native):
    """A smaller .npy in a batch fails loudly on the native and on the numpy
    path (``tests/test_data.py``'s case), never leaving garbage in its slot."""
    pg, ps = tmp_path / "good.npy", tmp_path / "short.npy"
    np.save(pg, np.arange(24, dtype=np.float32).reshape(2, 3, 4))
    np.save(ps, np.arange(12, dtype=np.float32).reshape(2, 3, 2))
    if not native:
        monkeypatch.setattr(tnl, "_load", lambda: None)
    out = np.empty((2, 2, 3, 4), np.float32)
    with pytest.raises((IOError, ValueError)) as exc:
        tnl.read_batch([str(pg), str(ps)], out)
    if native:
        with pytest.raises(IOError) as ref:
            jnl.read_batch([str(pg), str(ps)], np.empty((2, 2, 3, 4), np.float32))
        assert str(exc.value) == str(ref.value)
        assert "short.npy" in str(exc.value)


@pytest.mark.parametrize("threads", [1, 4])
def test_numpy_path_reads_what_the_native_path_reads(tmp_path, monkeypatch, threads):
    rng = np.random.default_rng(9)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"c{i}.npy")
        np.save(p, rng.standard_normal((2, 4, 6)).astype(np.float64 if i else np.float32))
        paths.append(p)
    native = np.empty((3, 2, 4, 6), np.float32)
    tnl.read_batch(paths, native, threads=threads)
    monkeypatch.setattr(tnl, "_load", lambda: None)
    assert not tnl.native_available()
    fallback = np.empty_like(native)
    tnl.read_batch(paths, fallback, threads=threads)
    np.testing.assert_array_equal(native, fallback)
