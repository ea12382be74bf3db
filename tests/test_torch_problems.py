"""The oracle suite (``utils.problems``): every problem the JAX package's
bitwise, and the solvers on each matching per lane, in f64 on the CPU."""
import numpy as np
import pytest
import torch

import ccqppy_tpu as cq
from ccqppy_tpu.utils import problems as jproblems
from ccqppy_tpu_torch.models import bbpgd, mprgp, pcg
from ccqppy_tpu_torch.utils import problems
from ccqppy_tpu_torch.utils.convert import config_from_jax

torch.set_num_threads(1)

NAMES = ["unconstrained_spd_1", "unconstrained_spd_2", "box_constrained_spd",
         "thin_box_constrained_spd", "active_box_constrained_spd", "readme_problem"]
SOLVERS = {"bbpgd": (cq.models.bbpgd.solve, bbpgd.solve, cq.models.BBPGDConfig),
           "pcg": (cq.models.pcg.solve, pcg.solve, cq.models.PCGConfig),
           "mprgp": (cq.models.mprgp.solve, mprgp.solve, cq.models.MPRGPConfig)}


def _pair(name):
    return getattr(jproblems, name)(), getattr(problems, name)(device="cpu")


def _params(proj):
    """Every parameter buffer of a port projection, by name, as numpy."""
    return {k: v.numpy() for k, v in proj.named_buffers()}


@pytest.mark.parametrize("name", NAMES)
def test_problem_matches_jax_bitwise(name):
    jp, tp = _pair(name)
    assert tp.name == jp.name and tp.number_of_unknowns == jp.number_of_unknowns == 3
    assert tp.A.shape == (1, 3, 3) and tp.b.shape == tp.exact_solution.shape == (1, 3)
    for field in ("A", "b", "exact_solution"):
        t, j = getattr(tp, field), np.asarray(getattr(jp, field))
        assert t.dtype == torch.float64 and t.device.type == "cpu"
        np.testing.assert_array_equal(t[0].numpy(), j)
    assert type(tp.proj).__name__ == type(jp.proj).__name__
    params = _params(tp.proj)
    for key in ("lb", "ub"):
        if hasattr(jp.proj, key):
            np.testing.assert_array_equal(params[key], np.asarray(getattr(jp.proj, key)))
    if name == "unconstrained_spd_2":
        assert tp.proj.block_dim == jp.proj.block_dim == 1


@pytest.mark.parametrize("name", NAMES)
def test_solvers_match_jax_on_problem(name):
    """bbpgd, pcg and mprgp at tol 1e-10: x to 1e-10, the residual,
    ``converged`` and matvecs per lane, and x* to 1e-6."""
    jp, tp = _pair(name)
    for sname, (jsolve, tsolve, cfg_cls) in SOLVERS.items():
        jcfg = cfg_cls(tol=1e-10, max_matvecs=1000)
        rj = jsolve(jp.A, jp.b, proj=jp.proj, config=jcfg)
        rt = tsolve(tp.A, tp.b, proj=tp.proj, config=config_from_jax(jcfg))
        assert bool(rj.converged) and bool(rt.converged[0]), sname
        assert int(rt.matvecs[0]) == int(rj.matvecs), sname
        np.testing.assert_allclose(rt.x[0].numpy(), np.asarray(rj.x), rtol=0, atol=1e-10,
                                   err_msg=sname)
        np.testing.assert_allclose(float(rt.residual[0]), float(rj.residual), rtol=0,
                                   atol=1e-12, err_msg=sname)
        np.testing.assert_allclose(rt.x.numpy(), tp.exact_solution.numpy(), atol=1e-6,
                                   err_msg=sname)


def test_f32_problem_and_default_device():
    """The suite in f32 keeps its values; with no CUDA the default device
    raises rather than falling back."""
    tp = problems.active_box_constrained_spd(torch.float32, "cpu")
    assert tp.A.dtype == tp.b.dtype == tp.proj.lb.dtype == torch.float32
    np.testing.assert_array_equal(tp.b.numpy(), [[-1.0, 0.0, -1.0]])
    assert len(problems.all_problems(device="cpu")) == 5
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        problems.box_constrained_spd()
