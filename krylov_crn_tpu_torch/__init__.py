"""krylov_crn_tpu_torch — the PyTorch / CUDA port of ``krylov_crn_tpu``.

The cubic-regularized Newton solvers on one NVIDIA H100: the Gram-space
Krylov solver (fp32 storage with compensated two-float reductions, exact
host fp64 corrections at chunk boundaries) over the upper-triangle SYMV
kernel (``csrc/symv.cu``), and the d-space Krylov and full-space CRN
solvers over the dense matvec kernel (``csrc/matvec.cu``) or CSR
products. Module names mirror the JAX package so each counterpart is easy
to find:

* ``data``    — numpy-only synthetic generators, label canonicalization,
                and the device format ``DualSparse`` (CSR A and A^T, dense
                copies for small d);
* ``ops``     — two-float math, the kernel wrappers (SYMV, matvec), SpMV,
                Gram data and the K build, Lanczos (Gram-space and
                d-space), CG, the cubic subproblem solvers;
* ``models``  — the logistic-regression oracle;
* ``solvers`` — the run-loop base, ``GramKrylov``, ``CubicKrylov``,
                ``CubicNewton``;
* ``utils``   — ``Trace`` and device timing;
* ``tools``   — ``measure_matvec``;
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
from krylov_crn_tpu_torch.solvers.krylov_crn import CubicKrylov  # noqa: E402,F401
from krylov_crn_tpu_torch.solvers.krylov_gram import GramKrylov  # noqa: E402,F401
from krylov_crn_tpu_torch.utils.trace import Trace  # noqa: E402,F401
