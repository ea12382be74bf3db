"""Analytical oracle problem suite with known exact solutions.

Port of ``ccqppy_tpu/utils/problems.py``: the same five problems of the
reference ``problem_suite`` and the README's, sharing the 3x3 SPD
tridiagonal Hessian ``A = tridiag(-1, 2, -1)`` with ``b = -A x_exact``.
Each ``OracleProblem`` holds a batch of one -- A (1, 3, 3), b (1, 3),
``exact_solution`` (1, 3) -- and its projection, all on ``device``, so a
solver takes it as it is.
"""
from __future__ import annotations

import dataclasses

import torch

from ccqppy_tpu_torch.ops import projections as P

_TRIDIAG = [[2.0, -1.0, 0.0], [-1.0, 2.0, -1.0], [0.0, -1.0, 2.0]]


@dataclasses.dataclass(frozen=True)
class OracleProblem:
    """A QP with a known unique exact solution, as a batch of one."""

    name: str
    A: torch.Tensor               # (1, 3, 3)
    b: torch.Tensor               # (1, 3)
    proj: P.Projection
    exact_solution: torch.Tensor  # (1, 3)

    @property
    def number_of_unknowns(self):
        return self.b.shape[-1]


def _tridiag(dtype, device):
    return torch.tensor([_TRIDIAG], dtype=dtype, device=device)


def _make(name, proj, x_exact, dtype, device, x_uncon=None):
    """The problem whose unconstrained optimum is ``x_uncon`` (default:
    ``x_exact``), ``b = -A x_uncon``."""
    A = _tridiag(dtype, device)
    x = torch.tensor([x_exact], dtype=dtype, device=device)
    u = x if x_uncon is None else torch.tensor([x_uncon], dtype=dtype, device=device)
    return OracleProblem(name, A, -(A @ u[..., None])[..., 0], proj, x)


def unconstrained_spd_1(dtype=torch.float64, device="cuda"):
    """problem_suite.py:42-66 -- identity projection, x* = [1, 0, 1]."""
    return _make("UnconstrainedSPD1", P.identity(), [1.0, 0.0, 1.0], dtype, device)


def unconstrained_spd_2(dtype=torch.float64, device="cuda"):
    """problem_suite.py:69-93 -- product of three 1-dim identity blocks."""
    return _make("UnconstrainedSPD2", P.blockwise(P.identity(), 1), [1.0, 0.0, 1.0],
                 dtype, device)


def box_constrained_spd(dtype=torch.float64, device="cuda"):
    """problem_suite.py:96-121 -- box [0,2]^3, inactive at the optimum."""
    proj = P.box([0.0] * 3, [2.0] * 3, dtype, device)
    return _make("BoxConstrainedSPD", proj, [1.0, 0.0, 1.0], dtype, device)


def thin_box_constrained_spd(dtype=torch.float64, device="cuda"):
    """problem_suite.py:124-149 -- thin box, still inactive at the optimum."""
    proj = P.box([-10.0, -0.1, 0.9], [10.0, 0.1, 1.1], dtype, device)
    return _make("ThinBoxConstrainedSPD", proj, [1.0, 0.0, 1.0], dtype, device)


def active_box_constrained_spd(dtype=torch.float64, device="cuda"):
    """problem_suite.py:152-177 -- box [9,10]^3; the unconstrained optimum
    [1,1,1] lies outside, the constrained optimum is the corner [9,9,9]."""
    proj = P.box([9.0] * 3, [10.0] * 3, dtype, device)
    return _make("ActiveBoxConstrainedSPD", proj, [9.0, 9.0, 9.0], dtype, device,
                 x_uncon=[1.0, 1.0, 1.0])


def all_problems(dtype=torch.float64, device="cuda"):
    return [
        unconstrained_spd_1(dtype, device),
        unconstrained_spd_2(dtype, device),
        box_constrained_spd(dtype, device),
        thin_box_constrained_spd(dtype, device),
        active_box_constrained_spd(dtype, device),
    ]


def readme_problem(dtype=torch.float64, device="cuda"):
    """The README usage example (reference README.md:30-50): the same
    tridiagonal A, x_exact = [1, 0, 1] inside the box
    [-2,2] x [-2,2] x [-4,5]."""
    proj = P.box([-2.0, -2.0, -4.0], [2.0, 2.0, 5.0], dtype, device)
    return _make("READMEBox", proj, [1.0, 0.0, 1.0], dtype, device)
