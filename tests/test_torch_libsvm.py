"""The port's LIBSVM loader (krylov_crn_tpu_torch/data/libsvm.py): the
Python and native C parsers against the JAX package's parse_libsvm_bytes
on the same bytes (equal CSR and labels, exactly), compressed files,
zero-based detection and the download gate."""

import bz2
import gzip

import numpy as np
import pytest

from krylov_crn_tpu.data.libsvm import parse_libsvm_bytes as jparse
from krylov_crn_tpu_torch.data import libsvm
from krylov_crn_tpu_torch.data.libsvm import load_libsvm, parse_libsvm_bytes
from krylov_crn_tpu_torch.ops import _kernels

SAMPLE = b"""# a comment line
+1 1:0.5 3:-2.25 7:1e-3
-1 2:4 7:0.125

-1 1:1.0   3:2.5 # trailing comment
+1 4:-0.75
"""


def _random_bytes(seed=0, rows=200, d=500):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(rows):
        idxs = np.sort(rng.choice(d, size=rng.integers(0, 20),
                                  replace=False)) + 1
        toks = " ".join(f"{j}:{rng.standard_normal():.17g}" for j in idxs)
        lines.append(f"{rng.choice([-1, 1])} {toks}")
    return ("\n".join(lines) + "\n").encode()


def _same(got, want):
    (A, b), (Aj, bj) = got, want
    assert A.shape == Aj.shape and A.dtype == Aj.dtype
    np.testing.assert_array_equal(A.indptr, Aj.indptr)
    np.testing.assert_array_equal(A.indices, Aj.indices)
    np.testing.assert_array_equal(A.data, Aj.data)
    np.testing.assert_array_equal(b, bj)


@pytest.mark.parametrize("backend", ["python", "native", "auto"])
@pytest.mark.parametrize("data", [SAMPLE, _random_bytes()],
                         ids=["sample", "random"])
def test_parsers_match_jax(backend, data):
    _same(parse_libsvm_bytes(data, backend=backend),
          jparse(data, backend="python"))


def test_native_parser_builds_into_build_dir():
    """The C parser compiles at first use into the hashed _build/ name,
    never next to its source."""
    libsvm._native_library()
    built = list(_kernels.BUILD_DIR.glob("liblibsvm_parser_*.so"))
    assert built and _kernels.last_build_seconds["libsvm_parser"] >= 0.0
    assert not list(_kernels.CSRC.glob("*.so"))
    with pytest.raises(ValueError, match="malformed"):
        parse_libsvm_bytes(b"1 3-2.0\n", backend="native")


@pytest.mark.parametrize("compress, suffix", [(bz2.compress, ".bz2"),
                                              (gzip.compress, ".gz"),
                                              (bz2.compress, ".txt")])
def test_load_compressed(tmp_path, compress, suffix):
    """By suffix, or by magic bytes under another name."""
    p = tmp_path / f"tiny{suffix}"
    p.write_bytes(compress(SAMPLE))
    _same(load_libsvm(str(p)), jparse(SAMPLE, backend="python"))


def test_zero_based_detection():
    A, b = parse_libsvm_bytes(b"1 0:2.0 3:1.0\n-1 1:5.0\n")
    assert A.shape == (2, 4)
    assert A[0, 0] == 2.0 and A[0, 3] == 1.0 and A[1, 1] == 5.0
    A1, _ = parse_libsvm_bytes(b"1 1:2.0 4:1.0\n-1 2:5.0\n",
                               n_features=10)
    assert A1.shape == (2, 10) and A1[0, 0] == 2.0


def test_missing_file_with_downloads_off(tmp_path):
    with pytest.raises(FileNotFoundError, match="downloads are disabled"):
        load_libsvm("rcv1_train.binary", cache_dir=tmp_path,
                    allow_download=False)
