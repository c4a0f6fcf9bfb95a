"""LIBSVM/SVMlight text loader and label handling.

Port of ``krylov_crn_tpu/data/libsvm.py`` (the reference's sklearn
``load_svmlight_file`` + urlretrieve data path). Two parse backends, both
on the host:

* the native C parser (``csrc/libsvm_parser.c``), built with the host C
  compiler at first use into ``_build/`` (``ops/_kernels.py``);
* a pure-Python fallback that needs no toolchain.

Backend ``"auto"`` tries the native parser and falls back to Python, as
in the JAX package. Downloads are gated (off by default); pass a local
path or set ``allow_download=True`` where networking exists.
"""

from __future__ import annotations

import bz2
import ctypes
import gzip
import os
import warnings
from pathlib import Path

import numpy as np

__all__ = ["parse_libsvm_bytes", "load_libsvm", "canonicalize_labels",
           "LIBSVM_URL"]

LIBSVM_URL = ("https://www.csie.ntu.edu.tw/~cjlin/libsvmtools/datasets/"
              "binary/{}")
_BZ2_DATASETS = {"gisette_scale", "duke", "rcv1_train.binary",
                 "news20.binary"}


def _parse_python(data: bytes):
    """Pure-Python LIBSVM parse (fallback backend) -> (labels, rows, cols,
    vals)."""
    labels, rows, cols, vals = [], [], [], []
    r = 0
    for line in data.splitlines():
        line = line.split(b"#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        labels.append(float(parts[0]))
        for tok in parts[1:]:
            i, v = tok.split(b":")
            rows.append(r)
            cols.append(int(i))
            vals.append(float(v))
        r += 1
    return (
        np.asarray(labels, np.float64),
        np.asarray(rows, np.int64),
        np.asarray(cols, np.int64),
        np.asarray(vals, np.float64),
    )


def _native_library():
    from krylov_crn_tpu_torch.ops._kernels import load_host_library

    lib = load_host_library("libsvm_parser")
    if not getattr(lib, "_bound", False):
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.libsvm_count.restype = ctypes.c_int
        lib.libsvm_count.argtypes = [ctypes.c_char_p, ctypes.c_int64, i64p,
                                     i64p]
        arr = lambda dt: np.ctypeslib.ndpointer(dt, flags="C_CONTIGUOUS")
        lib.libsvm_fill.restype = ctypes.c_int
        lib.libsvm_fill.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    arr(np.float64), arr(np.int64),
                                    arr(np.int64), arr(np.float64)]
        lib._bound = True
    return lib


def _parse_native(data: bytes):
    """The C parser -> (labels f64, rows i64, cols i64, vals f64); raises
    on malformed input."""
    lib = _native_library()
    if not data.endswith(b"\n"):
        data = data + b"\n"
    n_rows, n_nnz = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.libsvm_count(data, len(data), ctypes.byref(n_rows),
                          ctypes.byref(n_nnz))
    if rc != 0:
        raise ValueError(f"libsvm_count failed: {rc}")
    labels = np.empty(n_rows.value, np.float64)
    rows = np.empty(n_nnz.value, np.int64)
    cols = np.empty(n_nnz.value, np.int64)
    vals = np.empty(n_nnz.value, np.float64)
    rc = lib.libsvm_fill(data, len(data), labels, rows, cols, vals)
    if rc != 0:
        raise ValueError(f"libsvm_fill failed: malformed input ({rc})")
    return labels, rows, cols, vals


def parse_libsvm_bytes(data: bytes, zero_based: str | bool = "auto",
                       n_features: int | None = None, backend: str = "auto"):
    """Parse LIBSVM text -> (A_csr float64, labels).

    ``zero_based``: LIBSVM files are conventionally 1-based; "auto" matches
    sklearn's rule (1-based unless a 0 index appears)."""
    import scipy.sparse as sp

    if backend == "auto":
        try:
            labels, rows, cols, vals = _parse_native(data)
        except Exception:
            labels, rows, cols, vals = _parse_python(data)
    elif backend == "native":
        labels, rows, cols, vals = _parse_native(data)
    else:
        labels, rows, cols, vals = _parse_python(data)

    if zero_based == "auto":
        zero_based = bool(cols.size) and int(cols.min()) == 0
    if not zero_based:
        cols = cols - 1
    n = int(labels.shape[0])
    d = int(cols.max()) + 1 if cols.size else 0
    if n_features is not None:
        d = max(d, int(n_features))
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, d), dtype=np.float64)
    return A, labels


def load_libsvm(dataset: str, cache_dir: str | os.PathLike = ".",
                allow_download: bool = False, backend: str = "auto"):
    """Load a dataset by name (LIBSVM binary collection) or by file path;
    ``.bz2`` and ``.gz`` files (by suffix or magic bytes) are
    decompressed."""
    p = Path(dataset)
    if not p.exists():
        p = Path(cache_dir) / (
            f"{dataset}.bz2" if dataset in _BZ2_DATASETS else dataset)
    if not p.exists():
        if not allow_download:
            raise FileNotFoundError(
                f"{dataset!r} not found locally and downloads are disabled. "
                "Provide a local file or use "
                "krylov_crn_tpu_torch.data.synthetic for synthetic "
                "stand-ins.")
        import urllib.request

        url = LIBSVM_URL.format(dataset)
        if dataset in _BZ2_DATASETS:
            url += ".bz2"
        urllib.request.urlretrieve(url, p)

    raw = p.read_bytes()
    if p.suffix == ".bz2" or raw[:3] == b"BZh":
        raw = bz2.decompress(raw)
    elif p.suffix == ".gz" or raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return parse_libsvm_bytes(raw, backend=backend)


def canonicalize_labels(b: np.ndarray) -> np.ndarray:
    """Map labels to {0, 1} with the reference's exact rules
    (optimizer/loss.py:190-207): {1,2}->{0,1}, {-1,1}->{0,1}, any other
    pair -> 1 for the first-seen label."""
    b = np.asarray(b)
    u = np.unique(b)
    if len(u) == 1:
        warnings.warn("The labels have only one unique value.")
        return b.astype(np.float64)
    if len(u) > 2:
        raise ValueError(
            "The number of classes must be no more than 2 for binary "
            "classification."
        )
    if np.array_equal(u, [0, 1]):
        return b.astype(np.float64)
    if np.array_equal(u, [1, 2]):
        return (b - 1).astype(np.float64)
    if np.array_equal(u, [-1, 1]):
        return ((b + 1) / 2).astype(np.float64)
    return (b == b[0]).astype(np.float64)
