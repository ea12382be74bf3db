"""Matplotlib visual helpers (host-side, optional).

Port of ``ccqppy_tpu/utils/plotting.py``, covering the reference's two
plotting features:

* ``plot_projection_samples`` -- 3-D scatter of projected uniform box
  samples (reference ``ProjOpBase.plot``); the samples are drawn with
  numpy, moved to the projection's device and projected as one
  ``(num_samples, dim)`` batch.
* ``plot_benchmark_metric`` -- per-projection-family mean-metric curves
  against problem size with 95% t-confidence bands (reference
  ``BenchmarkRandomCCQP.plot``).

matplotlib and scipy are imported inside the functions, so nothing else in
the package needs them.
"""
from __future__ import annotations

import numpy as np
import torch


def project_samples(proj, dim, num_samples, lb, ub, seed=0):
    """``num_samples`` points drawn uniformly from the box [lb, ub]^dim by
    ``numpy.random.default_rng(seed)`` and their projections, as numpy
    arrays ``(num_samples, dim)``.  The projection runs on the device and
    in the dtype of its parameters (on the CPU in f64, the samples' own
    dtype, for a set without any)."""
    lb = np.broadcast_to(np.asarray(lb, np.float64), (dim,))
    ub = np.broadcast_to(np.asarray(ub, np.float64), (dim,))
    xs = np.random.default_rng(seed).uniform(lb, ub, (num_samples, dim))
    buf = next(proj.buffers(), None)
    device = "cpu" if buf is None else buf.device
    dtype = torch.float64 if buf is None else buf.dtype
    projected = proj.project(torch.as_tensor(xs, dtype=dtype, device=device))
    return xs, projected.detach().cpu().numpy()


def plot_projection_samples(proj, dim, num_samples, lb, ub, seed=0, ax=None,
                            show=False):
    """Scatter projections of uniform samples from the box [lb, ub]^dim."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    _, projected = project_samples(proj, dim, num_samples, lb, ub, seed)
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
    cols = [projected[:, i] if i < dim else np.zeros(num_samples)
            for i in range(3)]
    ax.scatter(*cols)
    ax.set_xlabel("x0")
    ax.set_ylabel("x1")
    ax.set_zlabel("x2")
    if show:
        plt.show()
    return ax


def plot_benchmark_metric(metric_name, data, solver_names, family_names,
                          sizes, do_log_y=False, with_95_conf=True,
                          save_path=None, show=False):
    """Mean metric vs problem size per projection family, 95% t-bands.

    data: array [n_solvers, n_families, n_sizes, n_trials].
    """
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    import scipy.stats as st

    data = np.asarray(data)
    n_solvers, n_families, n_sizes, n_trials = data.shape
    fig, axes = plt.subplots(1, n_families, figsize=(4 * n_families, 4),
                             squeeze=False, sharey=True)
    for j, fam in enumerate(family_names):
        ax = axes[0, j]
        for i, sol in enumerate(solver_names):
            mean = data[i, j].mean(axis=-1)
            ax.plot(sizes, mean, marker="o", label=sol)
            if with_95_conf and n_trials > 1:
                sem = st.sem(data[i, j], axis=-1)
                half = sem * st.t.ppf((1 + 0.95) / 2.0, n_trials - 1)
                ax.fill_between(sizes, mean - half, mean + half, alpha=0.2)
        ax.set_title(fam)
        ax.set_xlabel("problem size")
        if do_log_y:
            ax.set_yscale("log")
    axes[0, 0].set_ylabel(metric_name)
    axes[0, -1].legend(fontsize=8)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    if show:
        plt.show()
    return fig
