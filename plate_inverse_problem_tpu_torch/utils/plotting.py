"""FRF plotting helpers.

Behavioral counterpart of the reference's plot utilities
(reference source/jax_plate/Utils.py:6-60, 70-71): two-panel frequency
response figures (magnitude+phase, or real+imaginary) and a matrix-to-png
dump.  matplotlib is imported lazily so the compute path never depends on it.

Host copy of the JAX package's ``utils/plotting.py``; a tensor (on the
card too) is moved to the host first.
"""
from __future__ import annotations

import numpy as np


def _host(a) -> np.ndarray:
    """A host array of a tensor (on any device) or array."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") \
        else np.asarray(a)


def _panels(freqs, fr, mode: str):
    """Panel data: list of (values, title, log_scale?)."""
    fr = _host(fr)
    freqs = _host(freqs)
    if mode == "Radial":
        mag = np.abs(fr)
        # phase relative to the imaginary axis, in units of pi (the
        # convention the reference plots)
        phase = np.arctan2(fr.real, fr.imag) / np.pi
        return [
            (mag, r"$\|u\|$", True),
            (phase, r"$\frac{\delta(\varphi)}{\pi}$", False),
        ]
    if mode == "Complex":
        return [
            (fr.real, r"$\Re(u)$", False),
            (fr.imag, r"$\Im(u)$", False),
        ]
    raise ValueError(f"kind can only be 'Radial' or 'Complex', got {mode}")


def _draw(freqs, fr, fig, axs, mode, **line_kwargs):
    for ax, (vals, title, log_scale) in zip(axs, _panels(freqs, fr, mode)):
        if log_scale:
            ax.set_yscale("log")
        ax.plot(_host(freqs), vals, **line_kwargs)
        ax.set_title(title)
        ax.set_xlabel("$f,\\ Hz$")
        ax.grid(True)
    axs[-1].legend()
    return fig, axs


def plot_fr_radial(freqs, fr, fig, axs, **line_kwargs):
    """Magnitude (log-scale) + phase-shift subplots on existing axes."""
    return _draw(freqs, fr, fig, axs, "Radial", **line_kwargs)


def plot_fr_complex(freqs, fr, fig, axs, **line_kwargs):
    """Real/imaginary-part subplots on existing axes."""
    return _draw(freqs, fr, fig, axs, "Complex", **line_kwargs)


def plot_fr(freqs, fr, fig=None, kind="Radial", **line_kwargs):
    """Two-panel FRF figure; pass ``fig`` to overlay further curves.

    When overlaying, the panel mode is inferred from the existing figure
    (log-scaled first axis => 'Radial'), matching the reference behaviour.
    """
    import matplotlib.pyplot as plt

    if fig is None:
        share_y = kind == "Complex"
        fig, axs = plt.subplots(
            figsize=(20, 10), nrows=1, ncols=2, sharex=True, sharey=share_y
        )
        return _draw(freqs, fr, fig, axs, kind, **line_kwargs)

    axs = fig.axes
    mode = "Radial" if axs[0].get_yscale() == "log" else "Complex"
    return _draw(freqs, fr, fig, axs, mode, **line_kwargs)


def png_matrix(M, fpath):
    """Dump a matrix as a paletted png (reference Utils.py:70-71)."""
    import matplotlib

    import matplotlib.image

    matplotlib.image.imsave(fpath, _host(M), cmap="Paired")
