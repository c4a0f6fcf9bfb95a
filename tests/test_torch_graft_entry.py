"""The port's harness entry points (krylov_crn_tpu_torch/graft_entry.py),
the CLI's ``--mesh`` and the multi-device tools, in four gloo ranks on
the CPU at small sizes."""

import json

import numpy as np
import pytest
import torch

from krylov_crn_tpu_torch import cli
from krylov_crn_tpu_torch.graft_entry import dryrun_multidevice, entry
from krylov_crn_tpu_torch.parallel.launch import rank_device
from krylov_crn_tpu_torch.tools import scaling_evidence, stress10m_dryrun

CPU = "cpu"  # the library's default device is the card


def test_entry_step_matches_the_jax_entry():
    """One Krylov-CRN step of ``entry`` on the CPU lowers the loss, and
    its value is the JAX entry point's within fp32 rounding."""
    import jax

    import __graft_entry__ as jg

    fn, args = entry(CPU)
    new = fn(*args)
    before, after = float(args[2].value), float(new.value)
    assert np.isfinite(after) and after < before
    jfn, jargs = jg.entry()
    jnew = jax.jit(jfn)(*jargs)
    assert abs(before - float(jargs[2].value)) < 1e-6
    assert abs(after - float(jnew.value)) < 1e-5


def test_dryrun_multidevice_four_cpu_ranks():
    """All four legs in four ranks: each lowers its loss (asserted inside
    the ranks), every rank reports the same values, and the sharded
    d-space step equals the step on the per-rank-loaded file."""
    res = dryrun_multidevice(4, CPU, timeout=120.0)
    assert len(res) == 4
    for leg in ("dspace", "gram", "fused", "libsvm"):
        before, after = res[0][leg]
        assert np.isfinite(after) and after <= before, leg
    # the byte-range loader splits rows elsewhere than the nnz-balanced
    # partition, so the sums differ in their last fp32 bits only
    assert abs(res[0]["libsvm"][1] - res[0]["dspace"][1]) < 1e-6
    assert res[0]["collectives"]["all_reduce"]["calls"] > 0
    assert res[0]["collectives"]["all_gather"]["calls"] > 0


def test_rank_device():
    assert rank_device("cpu", 3) == "cpu"
    assert rank_device("cuda:0", 3) == "cuda:0"
    assert rank_device("cuda", 3) == "cuda:3"


@pytest.mark.parametrize("solver", ["coo", "gram"])
def test_cli_mesh_runs_the_grid_in_four_ranks(tmp_path, solver, capfd):
    """``--mesh 4 --device cpu``: the grid runs row-sharded (coo) or on a
    row-banded K (gram), rank 0 alone prints and writes, and the traces
    end where the single-process grid's do."""
    argv = ["--dataset", "w8a", "--synthetic", "--it_max", "3",
            "--no-bench-run", "--SSCN_dim", "4", "--krylov_dim", "4",
            "--solver", solver, "--device", CPU,
            "--out-dir", str(tmp_path / "figs"),
            "--results-dir", str(tmp_path / "res")]
    if solver == "gram":
        # the Gram path needs n <= 4 d: the rcv1-like stand-in is too large
        # for a CPU test, so a small LIBSVM file takes its place
        from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg

        A, b = synthetic_logreg((300, 600, 6000), seed=4)
        path = tmp_path / "small.libsvm"
        with open(path, "w") as fh:
            for i in range(A.shape[0]):
                row = A.getrow(i).tocoo()
                fh.write(f"{int(b[i])} " + " ".join(
                    f"{j + 1}:{v:.17g}" for j, v in zip(row.col, row.data))
                    + "\n")
        argv = [str(path) if a == "w8a" else a for a in argv
                if a != "--synthetic"]
    assert cli.main(["--mesh", "4", *argv]) == 0
    out = capfd.readouterr().out
    assert out.count("Running optimizer: CRN") == 1  # rank 0 alone
    assert f"solver path: {solver} (mesh=4)" in out
    assert sorted(p.name for p in (tmp_path / "res").iterdir()) == [
        "CRN.pkl", "Krylov CRN (m = 4).pkl", "SSCN (m = 4).pkl"]
    assert len(list((tmp_path / "figs").iterdir())) == 1

    args = cli.build_parser().parse_args(argv)
    with pytest.raises(SystemExit, match="needs a mesh of 4 ranks"):
        cli.run_grid(cli.build_parser().parse_args(["--mesh", "4", *argv]))
    grid = cli.run_grid(args)  # --mesh 0: one process, as before
    from krylov_crn_tpu_torch.utils.trace import Trace

    for alg in (grid.krylov, *grid.sscn):
        tr = Trace.from_pickle(str(tmp_path / "res" / f"{alg.label}.pkl"))
        assert list(tr.its) == list(alg.trace.its)
        np.testing.assert_allclose(np.asarray(tr.loss_vals, np.float64),
                                   np.asarray(alg.trace.loss_vals,
                                              np.float64), rtol=1e-5)


def test_stress10m_dryrun_small(tmp_path):
    """The stress tool's whole path at 4,000 x 3,000 with 40,000 entries:
    one all-reduce of the d-vector per sharded HVP, no other collective,
    and the result within 1e-5 of the single-device HVP of the same
    entries."""
    out = tmp_path / "s.json"
    assert stress10m_dryrun.main([
        "--n", "4000", "--d", "3000", "--nnz", "40000", "--device", CPU,
        "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["ok"] and rec["device"] == "cpu" and rec["ranks"] == 4
    assert rec["all_reduces_per_hvp"] == 1
    assert rec["all_reduce_bytes_per_hvp"] == 4 * 3000
    assert rec["all_gathers_per_hvp"] == 0
    assert rec["nnz_local"] == [10000] * 4
    assert rec["rel_err_vs_single_device"] < 1e-5
    with pytest.raises(RuntimeError, match="must divide"):
        stress10m_dryrun.run(4001, 3000, 40000, 4, CPU, timeout=60.0)


def test_scaling_evidence_toy(tmp_path):
    """The collective budgets from the mesh's counters at the toy shape:
    one all-reduce per HVP, m + 1 per d-space step, m + 1 all-gathers and
    no all-reduce per Gram step; no projection in the JSON."""
    out = tmp_path / "c.json"
    assert scaling_evidence.main(["--shapes", "toy", "--device", CPU,
                                  "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["ok"] and "projection" not in rec
    toy = rec["shapes"]["toy"]
    m = scaling_evidence.M
    assert toy["sharded_hvp"]["collectives"]["all_reduce"] == dict(
        calls=1, bytes=4 * toy["d"], max_numel=toy["d"])
    assert toy["krylov_step"]["collectives"]["all_reduce"]["calls"] == m + 1
    g = toy["gram_step"]["collectives"]
    assert g["all_gather"]["calls"] == m + 1
    assert g["all_reduce"]["calls"] == 0
    assert toy["gram_step"]["band_shape"] == [toy["n_pad"] // 4,
                                              toy["n_pad"]]
    assert sum(toy["sharded_hvp"]["local_rows"]) == toy["n"]
    assert sum(toy["sharded_hvp"]["local_nnz"]) == toy["nnz"]


def test_finite_t_max_in_one_process_needs_no_mesh():
    """With a finite t_max a single process reads its own clock: no mesh,
    no broadcast (the four-rank CLI tests, whose --time_max is finite, run
    the branch that hands out rank 0's clock)."""
    from krylov_crn_tpu_torch import CubicKrylov, LogisticRegression
    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg

    A, b = synthetic_logreg((120, 80, 900), seed=1)
    alg = CubicKrylov(loss=LogisticRegression(A, b, dtype=np.float64,
                                              device=CPU),
                      reg_coef=1e-3, subspace_dim=4)
    alg.run(np.ones(80) * 0.5, it_max=3, t_max=1000.0)
    assert alg.mesh is None and alg.it == 3
    assert torch.isfinite(alg.state.value)
