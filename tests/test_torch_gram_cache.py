"""The K disk cache of the port's ``build_gram(cache_dir=)`` and
``GramKrylov(cache_dir=)`` against the JAX package's on the CPU: the same
key, the same cached array, a second build that reads the file, and file
names that keep fp32 and fp64 apart (the JAX package's do not)."""

from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from krylov_crn_tpu.ops import gram as jg
from krylov_crn_tpu_torch import GramKrylov, LogisticRegression
from krylov_crn_tpu_torch.ops import gram as tg

CPU = "cpu"  # the library's default device is the card


@pytest.fixture(scope="module")
def problem():
    """A 300 x 80 random CSR."""
    rng = np.random.default_rng(5)
    A = sp.random(300, 80, density=0.2, format="csr", random_state=rng)
    b = (rng.random(300) < 0.5).astype(np.float64)
    return A, b, np.ones(80) * 0.5


def _files(d):
    return sorted(p.name for p in Path(d).glob("*.npy"))


def test_cache_key_is_the_jax_packages(problem, small_problem):
    for A, _, x0 in (problem, small_problem):
        assert tg._cache_key(A, x0) == jg._cache_key(A, x0)
    A, _, x0 = problem
    assert tg._cache_key(A, x0 + 1.0) != tg._cache_key(A, x0)


def test_fp32_cache_file_holds_the_jax_packages_array(problem, tmp_path):
    A, b, x0 = problem
    jg.build_gram(A, b, x0, dtype=np.float32, cache_dir=str(tmp_path / "j"),
                  device_build=False)
    gd = tg.build_gram(A, b, x0, dtype=np.float32,
                       cache_dir=str(tmp_path / "t"), device=CPU)
    key = jg._cache_key(A, x0)
    assert _files(tmp_path / "j") == [f"gram_{key}.npy"]
    assert _files(tmp_path / "t") == [f"gram_{key}_float32.npy"]
    want = np.load(tmp_path / "j" / f"gram_{key}.npy")
    got = np.load(tmp_path / "t" / f"gram_{key}_float32.npy")
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gd.K[:300, :300].numpy(), want)


def test_second_build_reads_the_file(problem, tmp_path, monkeypatch):
    A, b, x0 = problem
    first = tg.build_gram(A, b, x0, dtype=np.float32, cache_dir=str(tmp_path),
                          device=CPU)

    def no_product(self, *a, **kw):
        raise AssertionError("the cached K was built again")

    # A A^T is the only transpose a build takes
    monkeypatch.setattr(type(A), "transpose", no_product)
    with pytest.raises(AssertionError):
        tg.build_gram(A, b, x0, dtype=np.float32, device=CPU)
    again = tg.build_gram(A, b, x0, dtype=np.float32,
                          cache_dir=str(tmp_path), device=CPU)
    assert torch.equal(again.K, first.K)
    assert torch.equal(again.K_lr.view(torch.int16),
                       first.K_lr.view(torch.int16))


def test_fp64_build_never_reads_fp32(problem, tmp_path):
    """An fp64 build after an fp32 build in the same directory: the port
    reads its own fp64 file and gives the exact fp64 K. The JAX package's
    file name holds no dtype, so its fp64 build reads the fp32 K (4.76e-7
    max abs off on this problem)."""
    A, b, x0 = problem
    fresh = tg.build_gram(A, b, x0, dtype=np.float64, device=CPU).K
    for _ in range(2):  # the second pass reads both files
        tg.build_gram(A, b, x0, dtype=np.float32, cache_dir=str(tmp_path),
                      device=CPU)
        got = tg.build_gram(A, b, x0, dtype=np.float64,
                            cache_dir=str(tmp_path), device=CPU).K
        assert got.dtype == torch.float64
        assert torch.equal(got, fresh)
    assert len(_files(tmp_path)) == 2

    jdir = str(tmp_path / "jax")
    jg.build_gram(A, b, x0, dtype=np.float32, cache_dir=jdir,
                  device_build=False)
    jfresh = np.asarray(jg.build_gram(A, b, x0, dtype=np.float64,
                                      device_build=False).K)
    jgot = np.asarray(jg.build_gram(A, b, x0, dtype=np.float64,
                                    cache_dir=jdir, device_build=False).K)
    np.testing.assert_array_equal(jfresh, fresh.numpy())
    assert np.max(np.abs(jgot - jfresh)) > 1e-8


def test_gram_krylov_writes_then_reuses_the_cache(problem, tmp_path,
                                                   monkeypatch):
    A, b, x0 = problem
    calls = {"save": 0, "load": 0}
    save, load = np.save, np.load

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tg.np, "save", counted("save", save))
    monkeypatch.setattr(tg.np, "load", counted("load", load))
    runs = []
    for _ in range(2):
        alg = GramKrylov(loss=LogisticRegression(A, b, dtype=np.float64,
                                                 device=CPU),
                         reg_coef=1e-3, subspace_dim=6, tolerance=0,
                         device=CPU, cache_dir=str(tmp_path))
        runs.append((alg.run_fused(x0, it_max=4, chunk=2), alg.gd))
        assert len(_files(tmp_path)) == 1
    assert calls == {"save": 1, "load": 1}
    (t1, g1), (t2, g2) = runs
    assert torch.equal(g1.K, g2.K) and g1.K_lr is None
    np.testing.assert_array_equal(t1.loss_vals, t2.loss_vals)
