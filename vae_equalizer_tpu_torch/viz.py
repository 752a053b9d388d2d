"""Constellation and correlation plots, debugging aids (port of
``vae_equalizer_tpu/viz.py``).

One implementation of what the reference duplicates in 8 files
(create_constellation_plot / plot_constellation / plot_correlation,
e.g. func_VAELE_MQAM_shaping.py:328-376). matplotlib is imported lazily, so
a job that never plots never pays for it. Every function takes numpy
arrays or tensors on any device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["constellation_plot", "correlation_plot", "expectation_constellation"]


def _plt():
    import matplotlib

    matplotlib.use(matplotlib.get_backend() or "Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def constellation_plot(e, labels=("X", "Y"), save: str | None = None, show: bool = False):
    """Scatter plot of complex or stacked-plane symbols: (2, N) planes,
    (pol, 2, N) planes, complex (N,) or complex (2, N), as the reference
    takes them. Returns the figure."""
    plt = _plt()
    e = _np(e)
    fig, ax = plt.subplots(figsize=(6, 5))
    colors = ("tab:red", "tab:blue")
    if np.iscomplexobj(e):
        pols = e if e.ndim == 2 else e[None]
        for i, z in enumerate(pols):
            ax.scatter(z.real, z.imag, s=2, c=colors[i % 2], alpha=0.5, label=labels[i % 2])
    else:
        pols = e if e.ndim == 3 else e[None]
        for i, xy in enumerate(pols):
            ax.scatter(xy[0], xy[1], s=2, c=colors[i % 2], alpha=0.5, label=labels[i % 2])
    ax.set_xlabel("In-Phase")
    ax.set_ylabel("Quadrature")
    ax.grid(True)
    ax.legend(loc="best")
    if save:
        fig.savefig(save, dpi=120, bbox_inches="tight")
    if show:
        plt.show()
    return fig


def expectation_constellation(q, amps, **kw):
    """Scatter of the posterior-mean constellation E_q[x] from q (..., 2n, N)."""
    q, amps = _np(q), _np(amps)
    n = amps.shape[0]
    e_i = np.einsum("...lt,l->...t", q[..., :n, :], amps)
    e_q = np.einsum("...lt,l->...t", q[..., n:, :], amps)
    return constellation_plot(np.stack([e_i, e_q], axis=-2), **kw)


def correlation_plot(x, tx, max_len: int = 1000, save: str | None = None, show: bool = False):
    """Cross-correlation of an equalized component against the tx stream,
    titled with the lag of its peak."""
    plt = _plt()
    x = _np(x)[..., :max_len].ravel()[:max_len]
    tx = _np(tx)[..., :max_len].ravel()[: x.shape[0]]
    corr = np.correlate(x, tx, "same")
    fig, ax = plt.subplots(figsize=(6, 3))
    ax.plot(corr)
    ax.set_xlabel("lag")
    ax.set_ylabel("correlation")
    ax.set_title(f"peak at {int(np.argmax(np.abs(corr)))}")
    if save:
        fig.savefig(save, dpi=120, bbox_inches="tight")
    if show:
        plt.show()
    return fig
