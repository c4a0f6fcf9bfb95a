#!/bin/bash
# Figure-2 reproduction grid (the reference's cubic_newton.sh:1-8) on the
# PyTorch port, on the first NVIDIA card (add --device cpu to every line
# for a CPU run). Without the LIBSVM files, synthetic stand-ins shaped like
# the datasets are substituted; drop --synthetic and place the real files
# next to this script to reproduce the paper exactly. The figures need
# matplotlib; on a machine without it run the grid through
# krylov_crn_tpu_torch.cli.run_grid with --results-dir and plot elsewhere.
set -e
PY="python -m krylov_crn_tpu_torch.cli"

$PY --dataset w8a --synthetic --it_max 100
$PY --dataset w8a --synthetic --plot_time --it_max 50000 --time_max 60
$PY --dataset rcv1_train.binary --synthetic --it_max 50 --SSCN_dim 10 50 100 500
$PY --dataset rcv1_train.binary --synthetic --plot_time --it_max 50000 --time_max 60 --SSCN_dim 10 50 100 500
$PY --dataset news20.binary --synthetic --it_max 50 --SSCN_dim 10 50 500 1000
$PY --dataset news20.binary --synthetic --plot_time --it_max 50000 --time_max 60 --SSCN_dim 10 50 500 1000
