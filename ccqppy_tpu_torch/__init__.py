"""ccqppy_tpu_torch -- the PyTorch / CUDA port of ccqppy_tpu.

Solves batches of  min_x 1/2 x^T A x + b^T x  s.t.  x in Omega  with every
array carrying an explicit leading batch dimension ((B, n), (B, n, n); a
single problem is B = 1).  Everything runs on the device of its input
tensors; the batched GEMV and the packed symmetric matvec run as
hand-written Hopper kernels on CUDA tensors and as their plain PyTorch
versions on CPU tensors.

* ``ccqppy_tpu_torch.ops``      -- box, bound, ball and Lorentz-cone
                                   projections and their blockwise, product
                                   and segment compositions; dense, bf16
                                   (``CastDense``), mixed-precision (bf16 ->
                                   f32 and f32 -> f64), block-sparse,
                                   packed symmetric and spectral operators;
                                   the batched GEMV (f32, bf16, f64) and
                                   symv kernels and their build.
* ``ccqppy_tpu_torch.models``   -- the verified projected-CG face solver
                                   (``pcg``, with residual replacement),
                                   MPRGP and MPRGP-BB (``mprgp``),
                                   projected gradient (``pgd``), BBPGD and
                                   BBPGDf (``bbpgd``), classic APGD and
                                   APGD-AR with backtracking and
                                   strong-convexity APGD (``apgd``), the
                                   spectral projected gradient (``spg``)
                                   and direct serving (``direct``).
* ``ccqppy_tpu_torch.parallel`` -- batched solves with straggler compaction,
                                   the bf16 -> f32 precision ladder, and the
                                   distributed layer on ``torch.distributed``
                                   (scenario-sharded batches, row-sharded
                                   QPs, process groups and meshes).
* ``ccqppy_tpu_torch.utils``    -- the analytical oracle problems
                                   (``problems``), random QP ensembles,
                                   per-lane RNG keys (``rng``), guarded
                                   timing and the random-ensemble benchmark
                                   harness (``benchmark``), diagnostics
                                   (``diagnostics``: timing, residual
                                   traces, profiling, result checks),
                                   plotting, and conversion of problems,
                                   sets and configs from the JAX package.
* ``ccqppy_tpu_torch.compat``   -- the drop-in CCQPpy class API
                                   (``CCQPSolver*``, ``*ProjOp``); import it
                                   by name.

Gradient convention: ``g = A x + b``.
"""

__version__ = "0.1.0"

from ccqppy_tpu_torch import models, ops, parallel, utils  # noqa: F401
from ccqppy_tpu_torch.models import (SOLVERS, APGDConfig,  # noqa: F401
                                     APGDSCConfig, BBPGDConfig, BBPGDfConfig,
                                     MPRGPBBConfig, MPRGPConfig, PCGConfig,
                                     PGDConfig, SolveResult, SolverConfig,
                                     SPGConfig, apgd, bbpgd, mprgp, pcg, pgd,
                                     spg)
from ccqppy_tpu_torch.ops import projections, symv  # noqa: F401
from ccqppy_tpu_torch.ops.linop import (BlockSparseOperator,  # noqa: F401
                                        CastDense, DenseOperator, FastDense,
                                        LinearOperator, MixedPrecDense,
                                        ShardedBlockSparseOperator,
                                        ShardedDenseOperator, SpectralDense,
                                        SymmetricPackedDense, as_operator,
                                        estimate_spectral_bounds)
from ccqppy_tpu_torch.ops.projections import (BallProj, BlockwiseProj,  # noqa: F401
                                              BoxProj, IdentityProj,
                                              LorentzConeProj, LowerBoundProj,
                                              ProductProj, SegmentProj,
                                              UpperBoundProj, ball, blockwise,
                                              box, identity, lorentz_cone,
                                              lower_bound, segment_product,
                                              upper_bound)
