"""Experiment driver: the port of ``krylov_crn_tpu/cli.py`` (the reference's
cubic_newton.py:14-161 — flags, run grid, empirical-f* protocol, figures).

Usage:
    python -m krylov_crn_tpu_torch.cli --dataset w8a --it_max 100
    python -m krylov_crn_tpu_torch.cli --dataset rcv1_train.binary \\
        --plot_time --it_max 50000 --time_max 60 --SSCN_dim 10 50 100 500
    python -m krylov_crn_tpu_torch.cli --device cpu --dataset w8a \\
        --synthetic --it_max 3

Everything runs on ``cuda:0``; without a card the CLI exits with an error
unless ``--device cpu`` is given (the port's one flag beyond the JAX
CLI's). ``run_grid`` runs the optimizers and needs neither matplotlib nor
seaborn; ``main`` adds the figure.

``--mesh N`` runs the grid in N ranks (``parallel/``): rows of A sharded
on the d-space path, K row-banded on the Gram path. Started plainly, the
CLI launches the N ranks itself (``parallel.launch``): a card per rank
over NCCL when the host has N cards, else all ranks on ``cuda:0`` over
gloo, or on the CPU with ``--device cpu``. Under ``torchrun
--nproc-per-node N`` it joins the launcher's process group instead and
requires N to equal the world size. Rank 0 alone prints, plots and writes
``--results-dir``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

_SYNTH_ALIASES = {
    "w8a": "w8a-like",
    "rcv1_train.binary": "rcv1-like",
    "news20.binary": "news20-like",
}


def build_parser():
    p = argparse.ArgumentParser(description="Cubic Regularized Newton Methods")
    p.add_argument("--dataset", metavar="DATASETS", default="w8a", type=str,
                   help="LIBSVM dataset name, local path, or synthetic name")
    p.add_argument("--plot_time", dest="plot_time", action="store_true",
                   help="Plot with respect to time")
    p.add_argument("--it_max", default=50000, type=int, metavar="IT",
                   help="max iteration")
    p.add_argument("--time_max", default=60, type=float, metavar="T",
                   help="max time")
    p.add_argument("--SSCN_dim", nargs="+", default=10, type=int,
                   metavar="D", help="Subspace dimensions of SSCN")
    p.add_argument("--synthetic", action="store_true",
                   help="use a synthetic stand-in shaped like the dataset")
    p.add_argument("--krylov_dim", default=10, type=int,
                   help="Krylov subspace dimension m")
    p.add_argument("--l2", default=0.0, type=float)
    p.add_argument("--dtype", default=None, choices=[None, "float32",
                                                     "float64"],
                   help="storage dtype (default float32)")
    p.add_argument("--allow-download", action="store_true")
    p.add_argument("--mesh", default=0, type=int,
                   help="run in N ranks: rows of A (d-space path) or row "
                        "bands of K (Gram path) split over them")
    p.add_argument("--no-bench-run", action="store_true",
                   help="skip the 5x-budget benchmark run used for f*")
    p.add_argument("--fused", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="run the Gram Krylov solver chunk-fused: "
                        "full-resolution loss trace, host sync and exact "
                        "fp64 corrections once per chunk (--no-fused for "
                        "the step-for-step run)")
    p.add_argument("--solver", default="auto",
                   choices=["auto", "gram", "coo"],
                   help="compute path: gram = dense-K formulation "
                        "(n <= ~45k), coo = sparse d-space path, auto = "
                        "pick per problem shape")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="cuda (default, the first card; exits without "
                        "one) or cpu")
    p.add_argument("--out-dir", default="figs")
    p.add_argument("--results-dir", default=None,
                   help="pickle traces into this directory")
    return p


def load_dataset(args):
    """Returns (A_csr, b) honoring --synthetic and local files."""
    from krylov_crn_tpu_torch.data.libsvm import load_libsvm
    from krylov_crn_tpu_torch.data.synthetic import (
        DATASET_SHAPES,
        synthetic_logreg,
    )

    name = args.dataset
    key = name if name in DATASET_SHAPES else _SYNTH_ALIASES.get(name)
    if args.synthetic:
        if key is None:
            raise SystemExit(f"no synthetic stand-in for {name!r}; "
                             f"choices: {sorted(DATASET_SHAPES)}")
        print(f"[cli] using synthetic stand-in for {name} ({key})")
        return synthetic_logreg(key, seed=0)
    if key in DATASET_SHAPES and not os.path.exists(name):
        try:
            return load_libsvm(name, allow_download=args.allow_download)
        except FileNotFoundError:
            print(f"[cli] {name} not found locally and downloads disabled; "
                  f"falling back to synthetic stand-in ({key})")
            return synthetic_logreg(key, seed=0)
    return load_libsvm(name, allow_download=args.allow_download)


def resolve_cli_device(args):
    """``cuda:0`` unless ``--device cpu``; no silent CPU fallback."""
    import torch

    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("[cli] CUDA is not available "
                         "(torch.cuda.is_available() is False); pass "
                         "--device cpu to run on the CPU")
    return torch.device("cuda", 0)


@dataclasses.dataclass
class Grid:
    """The run grid's optimizers, oracles and empirical f*."""

    crn: object
    sscn: list
    krylov: object
    krylov_bench: object | None
    loss: object
    loss_csc: object
    f_opt: float
    n: int
    d: int
    use_gram: bool


def run_grid(args, mesh=None) -> Grid:
    """Load the data and run the reference's grid (cubic_newton.py:63-111):
    CRN, SSCN for each --SSCN_dim, Krylov CRN and (unless --no-bench-run)
    the 5x-budget Krylov run; f* = min over both oracles' best values.

    ``mesh`` (several ranks, each calling this with the same ``args``):
    the d-space path runs on row-sharded data, the Gram path on a
    row-banded K, on the mesh's device; only rank 0 prints and saves."""
    import builtins

    if mesh is not None and not mesh.distributed:
        mesh = None
    if args.mesh and (mesh is None or mesh.world != args.mesh):
        raise SystemExit(
            f"[cli] --mesh {args.mesh} needs a mesh of {args.mesh} ranks "
            f"(got {'none' if mesh is None else mesh.world}); cli.main "
            "starts or joins them")
    lead = mesh is None or mesh.rank == 0
    print = builtins.print if lead else (lambda *a, **k: None)
    dev = resolve_cli_device(args) if mesh is None else mesh.device

    m_list = args.SSCN_dim
    if isinstance(m_list, int):
        m_list = [m_list]

    A, b = load_dataset(args) if lead else _load_quietly(args)
    n, dim = A.shape
    print(f"[cli] {args.dataset}: n={n:,} d={dim:,} nnz={A.nnz:,} on {dev}")

    from krylov_crn_tpu_torch.models.logistic import LogisticRegression
    from krylov_crn_tpu_torch.solvers.crn import CubicNewton
    from krylov_crn_tpu_torch.solvers.crn_gram import GramCRN
    from krylov_crn_tpu_torch.solvers.krylov_crn import CubicKrylov
    from krylov_crn_tpu_torch.solvers.krylov_gram import GramKrylov
    from krylov_crn_tpu_torch.solvers.sscn import SSCN

    dtype = np.dtype(args.dtype or np.float32)
    # Gram path: the dense n x n K fits and beats sparse products; the
    # d-space path otherwise
    use_gram = args.solver == "gram" or (
        args.solver == "auto" and n <= 45056 and n <= 4 * dim)
    if mesh is not None and not use_gram:
        from krylov_crn_tpu_torch.parallel.sharded import build_sharded_dual

        loss = LogisticRegression(build_sharded_dual(A, mesh, dtype=dtype),
                                  b, l2=args.l2)
        # the sharded oracle serves SSCN's partials too; a second instance
        # would only duplicate the f* bookkeeping
        loss_csc = loss
    else:
        loss = LogisticRegression(A, b, l2=args.l2, dtype=dtype, device=dev)
        # the reference builds a CSC copy for SSCN (cubic_newton.py:55-59);
        # the device data already stores the transpose, so the second
        # oracle shares it and only serves the f* = min(f_opt, f_opt_csc)
        # protocol
        loss_csc = LogisticRegression(A, b, l2=args.l2, dtype=dtype,
                                      device=dev)
        loss_csc.data = loss.data

    x0 = np.ones(dim) * 0.5
    it_max, time_max = args.it_max, args.time_max

    # ---- algorithms (constructor grid of cubic_newton.py:63-88) ----
    memory_size = args.krylov_dim
    krylov_cls = GramKrylov if use_gram else CubicKrylov
    krylov_kw = dict(device=dev, mesh=mesh) if use_gram else {}
    print(f"[cli] solver path: {'gram' if use_gram else 'coo'}"
          + (f" (mesh={mesh.world})" if mesh is not None else ""))
    cub_krylov = krylov_cls(loss=loss, reg_coef=1e-3,
                            label=f"Krylov CRN (m = {memory_size})",
                            subspace_dim=memory_size, tolerance=1e-9,
                            **krylov_kw)
    memory_size_bench = 2 * memory_size
    cub_krylov_bench = krylov_cls(
        loss=loss, reg_coef=1e-3,
        label=f"Benchmark Krylov CRN (m = {memory_size_bench})",
        subspace_dim=memory_size_bench, tolerance=1e-9, **krylov_kw)
    cubic_solver = "full" if dim < 500 else "CG"
    if cubic_solver == "full" and mesh is not None and not use_gram:
        # row-sharded data keeps no dense copy of A for the dense Hessian
        print("[cli] row-sharded data: CRN runs its CG backend")
        cubic_solver = "CG"
    if cubic_solver == "CG" and use_gram:
        cub_root = GramCRN(loss=loss, reg_coef=1e-3, label="CRN",
                           tolerance=1e-8, **krylov_kw)
    else:
        cub_root = CubicNewton(loss=loss, reg_coef=1e-3, label="CRN",
                               cubic_solver=cubic_solver, tolerance=1e-8)
    sscn_list = [
        SSCN(loss=loss_csc, reg_coef=1e-3, label=f"SSCN (m = {m})",
             subspace_dim=m, tolerance=1e-9)
        for m in m_list
    ]

    # ---- run grid (cubic_newton.py:91-111) ----
    print(f"Running optimizer: {cub_root.label}")
    cub_root.run(x0=x0, it_max=it_max, t_max=time_max)
    cub_root.compute_loss_of_iterates()
    time_max = max(cub_root.trace.ts[-1], time_max)

    for alg in sscn_list:
        print(f"Running optimizer: {alg.label}")
        alg.run(x0=x0, it_max=it_max, t_max=time_max)
        alg.compute_loss_of_iterates()

    fused = args.fused and use_gram
    if args.fused and not use_gram:
        print("[cli] --fused requires the gram solver path; ignoring")

    print(f"Running optimizer: {cub_krylov.label}")
    if fused:
        cub_krylov.run_fused(x0, it_max=it_max, t_max=time_max)
    else:
        cub_krylov.run(x0=x0, it_max=it_max, t_max=time_max)
        cub_krylov.compute_loss_of_iterates()

    bench = None
    if not args.no_bench_run:
        bench = cub_krylov_bench
        print(f"Running optimizer: {bench.label}")
        if fused:
            bench.run_fused(x0, it_max=5 * it_max, t_max=5 * time_max)
        else:
            bench.run(x0=x0, it_max=5 * it_max, t_max=5 * time_max)
            bench.compute_loss_of_iterates()

    if args.results_dir and lead:
        for alg in [cub_root, cub_krylov, *sscn_list]:
            alg.trace.save(f"{alg.label}.pkl", path=args.results_dir)

    return Grid(crn=cub_root, sscn=sscn_list, krylov=cub_krylov,
                krylov_bench=bench, loss=loss, loss_csc=loss_csc,
                f_opt=min(loss.f_opt, loss_csc.f_opt), n=n, d=dim,
                use_gram=use_gram)


def plot_grid(args, grid: Grid) -> str:
    """The reference's figure (cubic_newton.py:113-161) into --out-dir;
    returns the PDF's path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    try:
        import seaborn as sns

        sns.set_style("ticks")
        sns.set_palette("colorblind")
    except ImportError:
        pass
    color_cycle = plt.rcParams["axes.prop_cycle"].by_key()["color"]
    plt.rcParams["pdf.fonttype"] = 42
    plt.rcParams["ps.fonttype"] = 42
    plt.rc("font", size=10)
    plt.rc("axes", titlesize=12, labelsize=12)
    plt.rc("xtick", labelsize=10)
    plt.rc("ytick", labelsize=10)
    plt.rc("legend", fontsize=10)
    plt.rc("figure", titlesize=14)

    plt.figure()
    f_opt = grid.f_opt
    grid.crn.trace.plot_losses(marker="o", markersize=5, f_opt=f_opt,
                               time=args.plot_time)
    for alg in grid.sscn:
        alg.trace.plot_losses(marker="^", markersize=6, f_opt=f_opt,
                              time=args.plot_time)
    grid.krylov.trace.plot_losses(marker="v", markersize=6, f_opt=f_opt,
                                  time=args.plot_time,
                                  color=color_cycle[7 % len(color_cycle)])
    plt.xlabel("Time (s)" if args.plot_time else "Iteration")
    plt.yscale("log")
    plt.legend()
    plt.grid()
    plt.title("{} ($n={:,}$, $d={:,}$)".format(args.dataset, grid.n, grid.d))

    os.makedirs(args.out_dir, exist_ok=True)
    mode = "time" if args.plot_time else "iteration"
    # basename so a local-path --dataset doesn't nest inside out_dir
    out = os.path.join(args.out_dir,
                       f"{mode}_{os.path.basename(args.dataset)}.pdf")
    plt.savefig(out)
    plt.close()
    print(f"[cli] saved {out}")
    return out


def _load_quietly(args):
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return load_dataset(args)


def _rank_main(mesh, argv):
    """One rank of ``--mesh N``: the grid, and on rank 0 the figure.
    Returns the grid's f* and iteration counts."""
    args = build_parser().parse_args(argv)
    grid = run_grid(args, mesh)
    if mesh is None or mesh.rank == 0:
        plot_grid(args, grid)
    return dict(f_opt=grid.f_opt, use_gram=grid.use_gram,
                its={alg.label: alg.it
                     for alg in (grid.crn, grid.krylov, *grid.sscn)})


def main(argv=None):
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if not args.mesh:
        _rank_main(None, argv)
        return 0
    import torch

    if "RANK" in os.environ:
        # started by torchrun: join its process group
        from krylov_crn_tpu_torch.parallel.mesh import make_mesh
        from krylov_crn_tpu_torch.parallel.multihost import init_distributed

        init_distributed(backend="gloo" if args.device == "cpu" else None)
        # on the card: cuda:<rank> under NCCL, the shared cuda:0 under gloo
        device = "cpu" if args.device == "cpu" else None
        _rank_main(make_mesh(args.mesh, device), argv)
        torch.distributed.destroy_process_group()
        return 0
    from krylov_crn_tpu_torch.parallel.launch import (
        backend_for,
        card_layout,
        run_ranks,
    )

    if args.device == "cpu":
        device = "cpu"
    else:
        resolve_cli_device(args)
        device = card_layout(args.mesh)
    run_ranks(_rank_main, args.mesh, backend_for(device), device,
              max(3600.0, 20 * args.time_max), argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
