"""The port's experiment CLI (krylov_crn_tpu_torch/cli.py) on the CPU:
tiny synthetic w8a on the d-space path, a local LIBSVM file (f* held to
the JAX CLI's within 1e-6 relative), a small Gram-path problem (GramCRN,
SSCN, fused GramKrylov, pickled traces), and the refusals."""

import numpy as np
import pytest
import torch

from krylov_crn_tpu_torch import cli
from krylov_crn_tpu_torch.parallel.mesh import single


def _write_libsvm(path, A, b):
    with open(path, "w") as fh:
        for i in range(A.shape[0]):
            row = A.getrow(i).tocoo()
            toks = " ".join(f"{j + 1}:{v:.17g}"
                            for j, v in zip(row.col, row.data))
            fh.write(f"{int(b[i])} {toks}\n")


def _record_f_opt(monkeypatch, trace_cls):
    """Record the f* each curve is plotted against, then plot it."""
    seen = []
    plot = trace_cls.plot_losses

    def spy(self, *args, f_opt=None, **kw):
        seen.append(f_opt)
        return plot(self, *args, f_opt=f_opt, **kw)

    monkeypatch.setattr(trace_cls, "plot_losses", spy)
    return seen


def test_cli_synthetic_w8a(tmp_path):
    rc = cli.main([
        "--device", "cpu", "--dataset", "w8a", "--synthetic",
        "--it_max", "3", "--time_max", "600", "--no-bench-run",
        "--SSCN_dim", "4", "--krylov_dim", "4", "--solver", "coo",
        "--out-dir", str(tmp_path)])
    assert rc == 0
    assert (tmp_path / "iteration_w8a.pdf").stat().st_size > 0


def test_cli_local_file_f_star_matches_jax_cli(tmp_path, monkeypatch):
    from krylov_crn_tpu import cli as jcli
    from krylov_crn_tpu.utils.trace import Trace as JTrace
    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg
    from krylov_crn_tpu_torch.utils.trace import Trace

    A, b = synthetic_logreg((120, 90, 900), seed=3)
    data = tmp_path / "mini.libsvm"
    _write_libsvm(data, A, b)
    argv = ["--dataset", str(data), "--it_max", "3", "--time_max", "600",
            "--no-bench-run", "--SSCN_dim", "4", "--krylov_dim", "4",
            "--solver", "coo"]
    f_port = _record_f_opt(monkeypatch, Trace)
    f_jax = _record_f_opt(monkeypatch, JTrace)
    assert cli.main(["--device", "cpu", "--out-dir",
                     str(tmp_path / "port"), *argv]) == 0
    assert jcli.main(["--out-dir", str(tmp_path / "jax"), *argv]) == 0
    assert (tmp_path / "port" / f"iteration_{data.name}.pdf").exists()
    assert len(set(f_port)) == 1 and len(set(f_jax)) == 1
    assert f_port[0] == pytest.approx(f_jax[0], rel=1e-6)


def test_cli_gram_path(tmp_path):
    """--solver gram with d >= 500: GramCRN as CRN, SSCN, fused
    GramKrylov; traces pickled into --results-dir."""
    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg

    A, b = synthetic_logreg((200, 600, 3000), seed=5)
    data = tmp_path / "gram.libsvm"
    _write_libsvm(data, A, b)
    args = cli.build_parser().parse_args([
        "--device", "cpu", "--dataset", str(data), "--it_max", "3",
        "--time_max", "600", "--no-bench-run", "--SSCN_dim", "20",
        "--krylov_dim", "4", "--solver", "gram",
        "--out-dir", str(tmp_path), "--results-dir", str(tmp_path / "res")])
    grid = cli.run_grid(args)
    assert grid.use_gram and type(grid.crn).__name__ == "GramCRN"
    assert grid.loss_csc.data is grid.loss.data
    fs = grid.crn.trace.metrics["exact_fs"]
    assert len(fs) == 3 and all(f2 <= f1 for f1, f2 in zip(fs, fs[1:]))
    assert np.isfinite(grid.f_opt) and grid.f_opt <= min(fs)
    assert len(list((tmp_path / "res").glob("*.pkl"))) == 3
    out = cli.plot_grid(args, grid)
    assert out.endswith("iteration_gram.libsvm.pdf")


def test_cli_refusals(monkeypatch):
    # --mesh N runs in N ranks, which cli.main starts or joins: the grid
    # itself refuses to run without them, or in another number of them
    args = cli.build_parser().parse_args(["--device", "cpu", "--mesh", "2"])
    with pytest.raises(SystemExit, match="needs a mesh of 2 ranks"):
        cli.run_grid(args)
    with pytest.raises(SystemExit, match="needs a mesh of 2 ranks"):
        cli.run_grid(args, mesh=single("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["--dataset", "w8a", "--synthetic"])
