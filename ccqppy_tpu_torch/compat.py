"""Drop-in compatibility layer mirroring the reference CCQPpy class API.

Port of ``ccqppy_tpu/compat.py``.  A CCQPpy user can switch imports and
keep their code, naming the device once:

    from ccqppy_tpu_torch.compat import CCQPSolverSPG, BoxProjOp
    op = BoxProjOp(3, lb, ub, device="cuda")
    result = CCQPSolverSPG(1e-10, 5000, device="cuda").solve(A, b, convex_proj_op=op)
    result.solution, result.solution_residual, ...

Class and argument names, defaults, and the ``solve() -> self`` /
``solution_*`` property protocol are those of the JAX package's layer.
Each problem is solved as a batch of one by the functional solvers, and
the ``solution_*`` properties read lane 0.  Arrays go in and come out as
unbatched numpy, in ``torch.get_default_dtype()`` read at call time (set
``torch.set_default_dtype(torch.float64)`` for the reference's f64
tolerances).

Every class takes a keyword-only ``device``, ``"cuda"`` by default; on a
machine without CUDA that raises, it never falls back to the CPU.  A
``*ProjOp`` on one device handed to a solver on another raises: it is not
moved, since moving a projection moves it in place.

``solution_time`` is the wall around the solve on ``time.perf_counter``,
closed by ``utils.benchmark.synchronize``.  On CUDA the kernels are built
and loaded (``ops.kernels.load``) before the clock starts, so the
first-use ``nvcc`` build never lands in it.

Deviations beyond the JAX package's own: SPG draws from the port's
per-lane key ``utils.rng.split_keys(spg_key, 1)``, not
``jax.random.PRNGKey(spg_key)``, so its iterates differ from the JAX
layer's; the cone projection is the correct SOC projection, as there.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ccqppy_tpu_torch.models import (APGDConfig, BBPGDConfig, BBPGDfConfig,
                                     MPRGPBBConfig, MPRGPConfig, PGDConfig,
                                     SPGConfig, apgd, bbpgd, mprgp, pgd, spg)
from ccqppy_tpu_torch.ops import kernels
from ccqppy_tpu_torch.ops import projections as P
from ccqppy_tpu_torch.utils import rng
from ccqppy_tpu_torch.utils.benchmark import synchronize


def _default_dtype():
    """Resolved at call time, not import time: a user who sets the default
    dtype after importing this module gets that dtype."""
    return torch.get_default_dtype()


def _device(device):
    """``device`` as a ``torch.device``, a CUDA one with its index (the
    current device's where none is given, as a tensor made there has); a
    CUDA device on a machine without CUDA raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but no CUDA device is available; "
                               "pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _tensor(x, device):
    return torch.as_tensor(x, dtype=_default_dtype(), device=device)


def _proj_device(proj):
    """The device of a projection's parameters; None for a set without any."""
    buf = next(proj.buffers(), None)
    return None if buf is None else buf.device


# --------------------------------------------------------------------------
# Projection operators (reference: solution_spaces.py)
# --------------------------------------------------------------------------
class _ProjOpWrapper:
    """Reference-style operator facade over a functional Projection."""

    def __init__(self, core, embedded_dimension, name, device):
        self._core = core
        self._dim = int(embedded_dimension)
        self._name = name
        self._device = device

    @property
    def core(self):
        return self._core

    @property
    def name(self):
        return self._name

    @property
    def embedded_dimension(self):
        return self._dim

    @property
    def device(self):
        return self._device

    def _point(self, x):
        return _tensor(x, self._device)[None]

    def __call__(self, x):
        return self._core.project(self._point(x))[0].cpu().numpy()

    def normal_vector(self, x):
        return self._core.normal(self._point(x))[0].cpu().numpy()

    def projected_gradient(self, x, g):
        free, chopped = self._core.free_chopped(self._point(x), self._point(g))
        return free[0].cpu().numpy(), chopped[0].cpu().numpy()

    def plot(self, num_random_samples, lb, ub, seed=0):
        """3-D scatter of projected uniform box samples -- reference
        ``ProjOpBase.plot``."""
        from ccqppy_tpu_torch.utils.plotting import plot_projection_samples
        return plot_projection_samples(self._core, self._dim,
                                       num_random_samples, lb, ub, seed=seed)


class IdentityProjOp(_ProjOpWrapper):
    def __init__(self, embedded_dimension, *, device="cuda"):
        super().__init__(P.identity(), embedded_dimension, "Identity", _device(device))


class LowerBoundProjOp(_ProjOpWrapper):
    def __init__(self, embedded_dimension, lower_bound=None, *, device="cuda"):
        device = _device(device)
        lb = (-torch.ones(embedded_dimension, dtype=_default_dtype(), device=device)
              if lower_bound is None else _tensor(lower_bound, device))
        super().__init__(P.LowerBoundProj(lb), embedded_dimension, "Lower Bound", device)


class UpperBoundProjOp(_ProjOpWrapper):
    def __init__(self, embedded_dimension, upper_bound=None, *, device="cuda"):
        device = _device(device)
        ub = (torch.ones(embedded_dimension, dtype=_default_dtype(), device=device)
              if upper_bound is None else _tensor(upper_bound, device))
        super().__init__(P.UpperBoundProj(ub), embedded_dimension, "Upper Bound", device)


class BoxProjOp(_ProjOpWrapper):
    def __init__(self, embedded_dimension, lower_bound=None, upper_bound=None, *,
                 device="cuda"):
        device = _device(device)
        lb = (-torch.ones(embedded_dimension, dtype=_default_dtype(), device=device)
              if lower_bound is None else _tensor(lower_bound, device))
        ub = (torch.ones(embedded_dimension, dtype=_default_dtype(), device=device)
              if upper_bound is None else _tensor(upper_bound, device))
        super().__init__(P.BoxProj(lb, ub), embedded_dimension, "Box", device)


class SphereProjOp(_ProjOpWrapper):
    def __init__(self, embedded_dimension, radius=None, *, device="cuda"):
        device = _device(device)
        r = 1.0 if radius is None else radius
        super().__init__(P.ball(r, dtype=_default_dtype(), device=device),
                         embedded_dimension, "Sphere", device)


class ConeProjOp(_ProjOpWrapper):
    def __init__(self, embedded_dimension, aspect_ratio=None, *, device="cuda"):
        device = _device(device)
        mu = 1.0 if aspect_ratio is None else aspect_ratio
        super().__init__(P.lorentz_cone(mu, dtype=_default_dtype(), device=device),
                         embedded_dimension, "Cone", device)


class DisjointProjOp(_ProjOpWrapper):
    """Cartesian product of sub-operators over contiguous blocks (reference
    solution_spaces.py:495-560).  The sub-operators must share a device,
    which is this operator's; ``device``, if given, must be that one."""

    def __init__(self, *proj_ops, device=None):
        devices = {op.device for op in proj_ops}
        if device is not None:
            devices.add(_device(device))
        if len(devices) != 1:
            raise ValueError(f"DisjointProjOp's parts lie on several devices: {devices}")
        dim = sum(op.embedded_dimension for op in proj_ops)
        core = P.ProductProj(*[(op.core, op.embedded_dimension) for op in proj_ops])
        super().__init__(core, dim, "Disjoint Union", devices.pop())


# --------------------------------------------------------------------------
# Solvers (reference: solvers.py)
# --------------------------------------------------------------------------
def _ready(device):
    """Build and load the CUDA kernels before a solve's clock starts (the
    first use compiles them with ``nvcc``)."""
    if device.type == "cuda":
        kernels.load()


class _SolverWrapper:
    """Reference-style ``solve() -> self`` facade over a functional solver."""

    _solve_fn = None
    _config_cls = None
    _name = None

    def __init__(self, desired_residual_tol,
                 max_matrix_vector_multiplications=2**31 - 1, *, device="cuda",
                 **extra):
        self.desired_residual_tol = desired_residual_tol
        self.max_matrix_vector_multiplications = max_matrix_vector_multiplications
        self.device = _device(device)
        self._extra = extra
        self._result = None

    def _config(self):
        max_mv = self.max_matrix_vector_multiplications
        if max_mv in (np.inf, float("inf")):
            max_mv = 2**31 - 1
        return self._config_cls(tol=float(self.desired_residual_tol),
                                max_matvecs=int(max_mv), **self._extra)

    def _proj(self, convex_proj_op):
        """The functional projection of ``convex_proj_op`` (a ``*ProjOp``, a
        ``Projection`` or None), which must lie on this solver's device."""
        if isinstance(convex_proj_op, _ProjOpWrapper):
            device, proj = convex_proj_op.device, convex_proj_op.core
        elif convex_proj_op is None:
            return None
        else:
            device, proj = _proj_device(convex_proj_op), convex_proj_op
        if device is not None and device != self.device:
            raise ValueError(f"the projection lies on {device}, the solver on {self.device}: "
                             "build it with the solver's device")
        return proj

    def _solve_kwargs(self):
        """Keyword arguments of the solver call beyond the config."""
        return {}

    def solve(self, A, b, x0=None, convex_proj_op=None):
        proj = self._proj(convex_proj_op)
        A = _tensor(A, self.device)[None]
        b = _tensor(b, self.device)[None]
        x0 = None if x0 is None else _tensor(x0, self.device)[None]
        config, kwargs = self._config(), self._solve_kwargs()
        _ready(self.device)
        synchronize((A, b, x0, list(kwargs.values())))
        t0 = time.perf_counter()
        r = type(self)._solve_fn(A, b, x0=x0, proj=proj, config=config, **kwargs)
        synchronize(r.x)
        self._solution_time = time.perf_counter() - t0
        self._result = r
        return self

    @property
    def name(self):
        return self._name

    @property
    def result(self):
        """The last solve's ``SolveResult``, a batch of one on the solver's
        device (for ``utils.diagnostics.check_result``)."""
        return self._result

    @property
    def solution(self):
        return self._result.x[0].cpu().numpy()

    @property
    def solution_residual(self):
        return float(self._result.residual[0])

    @property
    def solution_converged(self):
        return bool(self._result.converged[0])

    @property
    def solution_time(self):
        return self._solution_time

    @property
    def solution_num_matrix_vector_multiplications(self):
        return int(self._result.matvecs[0])


class CCQPSolverPGD(_SolverWrapper):
    _solve_fn = staticmethod(pgd.solve)
    _config_cls = PGDConfig
    _name = "PGD"

    def __init__(self, desired_residual_tol,
                 max_matrix_vector_multiplications=2**31 - 1, step_size=0.01, *,
                 device="cuda"):
        super().__init__(desired_residual_tol,
                         max_matrix_vector_multiplications, device=device,
                         step_size=float(step_size))


class CCQPSolverAPGD(_SolverWrapper):
    _solve_fn = staticmethod(apgd.solve)
    _config_cls = APGDConfig
    _name = "APGD"


class CCQPSolverAPGDAntiRelaxation(_SolverWrapper):
    _solve_fn = staticmethod(apgd.solve_anti_relaxation)
    _config_cls = APGDConfig
    _name = "Anti-relaxation APGD"

    def _config(self):
        return dataclasses.replace(super()._config(), anti_relaxation=True)


class CCQPSolverBBPGD(_SolverWrapper):
    _solve_fn = staticmethod(bbpgd.solve)
    _config_cls = BBPGDConfig
    _name = "BBPGD"


class CCQPSolverBBPGDf(_SolverWrapper):
    _solve_fn = staticmethod(bbpgd.solve_fallback)
    _config_cls = BBPGDfConfig
    _name = "BBPGDf"


class CCQPSolverSPG(_SolverWrapper):
    """SPG drop-in.  Deviation from the reference: the default stop criterion
    is the honest Eq. 25 residual, not the reference's ``||d_k|| <= tol``
    which can report success far from optimality -- pass
    ``criterion="d_norm"`` for the reference's stopping behaviour.  The
    draws come from the port key ``utils.rng.split_keys(spg_key, 1)``."""

    _solve_fn = staticmethod(spg.solve)
    _config_cls = SPGConfig
    _name = "SPG-QP"

    def __init__(self, desired_residual_tol,
                 max_matrix_vector_multiplications=2**31 - 1,
                 m=5, tau=0.5, sigma1=0.01, sigma2=0.5, spg_key=0,
                 criterion="eq25", *, device="cuda"):
        super().__init__(desired_residual_tol,
                         max_matrix_vector_multiplications, device=device,
                         m=int(m), tau=float(tau), sigma1=float(sigma1),
                         sigma2=float(sigma2), criterion=str(criterion))
        self._key = int(spg_key)

    def _solve_kwargs(self):
        return {"keys": rng.split_keys(self._key, 1, self.device)}


class CCQPSolverMPRGP(_SolverWrapper):
    _solve_fn = staticmethod(mprgp.solve)
    _config_cls = MPRGPConfig
    _name = "MPRGP"


class CCQPSolverMPRGPBB(_SolverWrapper):
    _solve_fn = staticmethod(mprgp.solve_bb)
    _config_cls = MPRGPBBConfig
    _name = "MPGP-BB"

    def __init__(self, desired_residual_tol,
                 max_matrix_vector_multiplications=2**31 - 1, Gamma=1.0, *,
                 device="cuda"):
        super().__init__(desired_residual_tol,
                         max_matrix_vector_multiplications, device=device,
                         gamma=float(Gamma))
