"""FRF point-budget reduction for faster inverse solves.

Dense experimental sweeps carry thousands of frequency points, but the loss
landscape is dominated by the resonance neighbourhoods.  ``Compressor``
shrinks a reference FRF to a point budget two ways (selector constants —
the 75 Hz peak-distance scale, Savitzky-Golay window 30/order 3, width > 20
samples, prominence > 0.1, roughness gate 50 — follow the reference
implementation, jax_plate/Input.py:66-158, and are part of the behavioral
contract):

* ``use_alg=0`` — even thinning of the frequency grid;
* ``use_alg=1`` — resonance-centric: detect ridges of the smoothed
  log-magnitude curve (both peaks and anti-resonance valleys), reject
  narrow/low-prominence/noisy candidates, then allocate the point budget as
  symmetric windows around the survivors, widened sweep-by-sweep until the
  budget is spent or neighbouring windows meet.

Beyond the reference: a clamped log floor keeps deep anti-resonances from
producing NaNs (Input.py:91 warns instead), and a ridge-free signal falls
back to even thinning rather than dividing by zero (Input.py:103).
"""
from __future__ import annotations

import numpy as np
from scipy.signal import find_peaks, peak_prominences, peak_widths, savgol_filter


def _even_thinning_mask(n: int, budget: int) -> np.ndarray:
    """Mark ~``budget`` indices on a stride-accumulated grid.

    Selects ``int(k * stride)`` for k = 0, 1, ... (so the first and last
    regions are always represented) and drops index 0 if rounding lands one
    point over budget.  (The reference accumulates the stride by repeated
    float addition, Input.py:74-78; the direct product differs from that by
    at most one index position as the accumulated rounding drifts.)"""
    stride = n / budget
    hops = np.arange(int(np.ceil(n / stride)) + 1) * stride
    picks = np.unique(hops[hops < n].astype(np.int64))
    mask = np.zeros(n, dtype=bool)
    mask[picks] = True
    if picks.size > budget:
        mask[0] = False
    return mask


def _ridge_candidates(curve: np.ndarray, min_gap: int) -> np.ndarray:
    """Indices of significant ridges of ``curve``: local maxima at least
    ``min_gap`` samples apart, wider than 20 samples, more prominent than
    0.1, and locally smooth (roughness gate below 50)."""
    locs, _ = find_peaks(curve, distance=min_gap)
    locs = locs[peak_widths(curve, locs)[0] > 20]
    locs = locs[peak_prominences(curve, locs)[0] > 0.1]
    return locs[_noise_score(curve, locs) < 50]


def _noise_score(curve: np.ndarray, locs: np.ndarray) -> np.ndarray:
    """Reciprocal mean absolute slope around each location.

    A genuine resonance rides a steep flank (large |d curve|, small score);
    measurement noise spikes sit on locally flat signal (small |d curve|,
    large score).  Window: up to 10 samples each side, shrunk near the
    array ends."""
    scores = np.empty(locs.size)
    n = curve.size
    for k, loc in enumerate(locs):
        edge = min(loc, n - loc)
        half = 10 if edge > 10 else edge - 1
        if half < 1:
            scores[k] = np.nan  # window collapsed at the array edge: reject
            continue
        wiggle = np.abs(np.diff(curve[loc - half: loc + half + 1])).sum()
        scores[k] = half / (10 * wiggle) if wiggle > 0 else np.inf
    return scores


def _widen_until_spent(lo: np.ndarray, hi: np.ndarray, n: int,
                       remaining: int, mask: np.ndarray) -> None:
    """Distribute ``remaining`` points by widening the ridge windows.

    Sweep policy (in place): each sweep first extends every window whose
    right edge has not met its right neighbour by one sample (left to
    right), then pushes the overall right boundary outward, falling back to
    the left boundary when the right end of the grid is exhausted.  Stops
    when the budget is spent or every window is wedged."""
    while remaining > 0:
        open_gaps = np.flatnonzero(hi[:-1] + 1 < lo[1:])[:remaining]
        hi[open_gaps] += 1
        mask[hi[open_gaps]] = True
        remaining -= open_gaps.size
        if remaining <= 0:
            return
        widened = open_gaps.size
        if hi[-1] + 1 < n:
            hi[-1] += 1
            mask[hi[-1]] = True
            remaining -= 1
            widened += 1
        elif lo[0] > 1:
            lo[0] -= 1
            mask[lo[0]] = True
            remaining -= 1
            widened += 1
        if widened == 0:
            return


class Compressor:
    """Reduce ``(freqs, complex_fr)`` to at most ``desired_size`` points.

    Construct with the full reference sweep, then call with the target
    count; returns the selected ``(freqs, complex_fr)`` subset.  ``max_size``
    caps the allowed target, ``use_alg`` picks the selector (0 even,
    1 resonance-centric).
    """

    def __init__(self, freqs: np.ndarray, complex_fr: np.ndarray,
                 max_size: int, use_alg: int):
        if freqs.size != complex_fr.size:
            raise ValueError(
                f"frequency grid ({freqs.size}) and FRF ({complex_fr.size}) "
                "lengths differ"
            )
        self.freqs = np.asarray(freqs)
        self.complex_fr = np.asarray(complex_fr)
        self.max_size = max_size
        self.alg = use_alg

    def _log_magnitude(self) -> np.ndarray:
        """Smoothed log|FRF|, floored so Savitzky-Golay undershoot near deep
        anti-resonances cannot reach log(<=0)."""
        mag = np.abs(self.complex_fr)
        fitted = savgol_filter(mag, min(30, mag.size - 1), 3)
        return np.log(np.maximum(fitted, max(mag.min() * 1e-3, 1e-300)))


    def _resonance_mask(self, budget: int) -> np.ndarray | None:
        n = self.freqs.size
        # minimum ridge separation: ~75 Hz expressed in grid samples
        min_gap = max(int(75 / np.max(np.diff(self.freqs))), 1)
        envelope = self._log_magnitude()

        # ridges of the curve and of its negation: resonances AND
        # anti-resonances both constrain the identified moduli
        ridges = np.sort(np.concatenate([
            _ridge_candidates(envelope, min_gap),
            _ridge_candidates(-envelope, min_gap),
        ]))
        if ridges.size == 0:
            return None

        half_width = max((budget - ridges.size) // (2 * ridges.size), 0)
        lo = np.maximum(ridges - half_width, 0)
        hi = np.where(ridges + half_width >= n, n - 1, ridges + half_width)

        mask = np.zeros(n, dtype=bool)
        for a, b in zip(lo, hi):
            mask[a: b + 1] = True
        _widen_until_spent(lo, hi, n, budget - int(mask.sum()), mask)
        return mask

    def __call__(self, desired_size: int) -> tuple[np.ndarray, np.ndarray]:
        if desired_size > self.max_size:
            raise ValueError(
                f"Desired size of compressed data must be lower than "
                f"{self.max_size + 1}"
            )

        if self.alg == 0:
            mask = _even_thinning_mask(self.freqs.size, desired_size)
        elif self.alg == 1:
            mask = self._resonance_mask(desired_size)
            if mask is None:  # ridge-free signal: fall back to even thinning
                mask = _even_thinning_mask(self.freqs.size, desired_size)
        else:
            raise NotImplementedError(f"Compression algorithm {self.alg}.")

        return self.freqs[mask], self.complex_fr[mask]
