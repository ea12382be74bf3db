"""ccqppy_tpu_torch -- the PyTorch / CUDA port of ccqppy_tpu.

Solves batches of  min_x 1/2 x^T A x + b^T x  s.t.  x in Omega  with every
array carrying an explicit leading batch dimension ((B, n), (B, n, n); a
single problem is B = 1).  Everything runs on the device of its input
tensors; the batched GEMV runs as a hand-written Hopper kernel on CUDA
tensors and as its plain PyTorch version on CPU tensors.

* ``ccqppy_tpu_torch.ops``      -- box / bound projections, dense operators,
                                   the batched GEMV kernel and its build.
* ``ccqppy_tpu_torch.models``   -- the verified projected-CG face solver
                                   (``pcg``) and direct serving (``direct``).
* ``ccqppy_tpu_torch.parallel`` -- batched solves with straggler compaction.
* ``ccqppy_tpu_torch.utils``    -- random QP ensembles, guarded timing, and
                                   conversion of problems, sets and configs
                                   from the JAX package.

Gradient convention: ``g = A x + b``.
"""

__version__ = "0.1.0"

from ccqppy_tpu_torch import models, ops, parallel, utils  # noqa: F401
from ccqppy_tpu_torch.models import (SOLVERS, PCGConfig, SolveResult,  # noqa: F401
                                     SolverConfig, pcg)
from ccqppy_tpu_torch.ops import projections  # noqa: F401
from ccqppy_tpu_torch.ops.linop import (DenseOperator, LinearOperator,  # noqa: F401
                                        as_operator)
from ccqppy_tpu_torch.ops.projections import (BoxProj, IdentityProj,  # noqa: F401
                                              LowerBoundProj, UpperBoundProj,
                                              box, identity, lower_bound,
                                              upper_bound)
