"""krylov_crn_tpu_torch — the PyTorch / CUDA port of ``krylov_crn_tpu``.

The cubic-regularized Newton solvers on NVIDIA H100 cards: the Gram-space
Krylov CRN and CRN-CG solvers (fp32 storage with compensated two-float
reductions, exact host fp64 corrections) over the upper-triangle SYMV
kernel (``csrc/symv.cu``), and the d-space Krylov, full-space CRN and SSCN
solvers over the dense matvec kernel (``csrc/matvec.cu``) or CSR
products. Module names mirror the JAX package so each counterpart is easy
to find:

* ``cli``     — the experiment driver (``python -m krylov_crn_tpu_torch.cli``);
* ``data``    — the LIBSVM loader (native C parser built at first use),
                numpy-only synthetic generators, label canonicalization,
                and the device format ``DualSparse`` (CSR A and A^T, dense
                copies for small d);
* ``ops``     — two-float math, the kernel wrappers (SYMV, matvec), SpMV,
                SSCN's column panels, Gram data and the K build, Lanczos
                (Gram-space and d-space), CG, the cubic subproblem solvers;
* ``models``  — the logistic-regression oracle;
* ``solvers`` — the run-loop base, ``GramKrylov``, ``GramCRN``,
                ``CubicKrylov``, ``CubicNewton``, ``SSCN``;
* ``parallel`` — the multi-device layer over ``torch.distributed``: the
                ``Mesh`` and its counted collectives, ``run_ranks``,
                ``ShardedDual`` (row-sharded A), per-rank LIBSVM loading;
                the Gram solvers take ``mesh=`` (row-banded K);
* ``utils``   — ``Trace``, checkpoints and device timing;
* ``tools``   — ``measure_matvec``, ``measure_symv``, ``measure_large_n``,
                ``run_figure2``, ``scaling_evidence``, ``stress10m_dryrun``;
* ``graft_entry`` — a harness's entry points (one step; the multi-rank dry
                run);
* ``convert`` — carries the JAX package's data and solver states across.

The JAX package is the reference; this package never imports ``jax``.
"""

__version__ = "0.1.0"

from krylov_crn_tpu_torch.config import (  # noqa: F401
    accum_dtype,
    pin_fp32_matmul_precision,
    resolve_device,
)

# fp32 algebra must be fp32 (no TF32): applied at import so no entry point
# can miss it (config.py)
pin_fp32_matmul_precision()

from krylov_crn_tpu_torch.data.formats import DualSparse  # noqa: E402,F401
from krylov_crn_tpu_torch.models.logistic import LogisticRegression  # noqa: E402,F401
from krylov_crn_tpu_torch.solvers.crn import CubicNewton  # noqa: E402,F401
from krylov_crn_tpu_torch.solvers.crn_gram import GramCRN  # noqa: E402,F401
from krylov_crn_tpu_torch.solvers.krylov_crn import CubicKrylov  # noqa: E402,F401
from krylov_crn_tpu_torch.solvers.krylov_gram import GramKrylov  # noqa: E402,F401
from krylov_crn_tpu_torch.solvers.sscn import SSCN  # noqa: E402,F401
from krylov_crn_tpu_torch.utils.trace import Trace  # noqa: E402,F401
