"""ROC's online linear cost model (roc_tpu/balance/cost_model.py):
t_p ~ w . [nodes, edges, halo_in, halo_out, 1].

The reference fits a linear model of per-partition runtime against simple
work counters and refits it every round as measurements arrive.  Here, as
in roc_tpu, a weighted ridge least-squares over the telemetry ring, with
two deviations from a textbook lstsq:

  * **Warm start.**  Before any telemetry exists the model must still rank
    cuts.  ``prior_times`` prices a part on the card: its edges at the sum
    kernel's rate (``memory/estimator.py:agg_s_per_edge_column``, one
    column-edge at a time: the autotuner's refit rate when the port's
    measured table exists, else the one measured ``AGG_S_PER_EDGE_COLUMN``),
    its rows and its halo rows at HBM bandwidth (``obs/roofline.py``'s
    ``PEAK_BW``; an exchange between parts on one card is a device copy),
    over the run's feature width.  ``fit`` mixes these in as pseudo-samples
    at ``PRIOR_WEIGHT``, or at roc_tpu's ``MEASURED_PRIOR_WEIGHT`` when the
    rate comes from the card's refit table (``tune/refit.py``,
    ``python -m roc_tpu_torch.tune --device --refit --update``), so early
    fits interpolate between the prior and the first probes.  roc_tpu's TPU
    chunk cost and its ICI term are not the card's and are not carried.
  * **Column scaling.**  edges ~ 1e4..1e8 while the constant column is 1;
    unscaled normal equations lose the small coefficients.  The solve runs
    in column-max-scaled space and unscales the weights.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from roc_tpu_torch.balance.telemetry import NUM_FEATURES
from roc_tpu_torch.memory.estimator import agg_s_per_edge_column
from roc_tpu_torch.obs.roofline import PEAK_BW

# The prior's feature width and wire itemsize when the caller does not
# thread the run's (the probe's width, an fp32 exchange); trainers pass the
# dataset width and the wire itemsize (2 under bf16 storage).
_PRIOR_HALO_WIDTH = 32
_PRIOR_HALO_ITEMSIZE = 4
# Relative weight of a synthesized prior sample vs a measured probe.
PRIOR_WEIGHT = 0.1
# The weight when the prior's edge rate is the card's refit rate
# (roc_tpu/balance/cost_model.py:56): a measured prior has earned more pull.
MEASURED_PRIOR_WEIGHT = 0.5


def measured_prior() -> bool:
    """True when the card's refit table backs the prior's edge rate."""
    from roc_tpu_torch.tune.refit import load_measured
    return load_measured() is not None


def prior_weights(halo_width: int = _PRIOR_HALO_WIDTH,
                  halo_itemsize: int = _PRIOR_HALO_ITEMSIZE) -> np.ndarray:
    """The warm-start prior as weights over (nodes, edges, halo_in,
    halo_out, 1): an output row written in fp32, an edge at the sum
    kernel's rate, a halo row copied at the wire's itemsize, each over
    ``halo_width`` columns."""
    w = float(halo_width)
    row = w * 4.0 / PEAK_BW
    halo = w * float(halo_itemsize) / PEAK_BW
    return np.array([row, w * agg_s_per_edge_column(), halo, halo, 0.0])


def prior_times(X: np.ndarray, halo_width: int = _PRIOR_HALO_WIDTH,
                halo_itemsize: int = _PRIOR_HALO_ITEMSIZE) -> np.ndarray:
    """Warm-start prediction for feature rows [n, 5] (nodes, edges,
    halo_in, halo_out, 1)."""
    X = np.atleast_2d(np.asarray(X, dtype=np.float64))
    return X @ prior_weights(halo_width, halo_itemsize)


class OnlineCostModel:
    """Weighted ridge least-squares over telemetry, refit each round."""

    def __init__(self, ridge: float = 1e-8,
                 halo_width: int = _PRIOR_HALO_WIDTH,
                 halo_itemsize: int = _PRIOR_HALO_ITEMSIZE,
                 measured: Optional[bool] = None):
        self.ridge = float(ridge)
        # the run's exchanged-feature width and wire itemsize; only the
        # warm-start prior reads them
        self.halo_width = int(halo_width)
        self.halo_itemsize = int(halo_itemsize)
        # None: MEASURED_PRIOR_WEIGHT when the card's refit table backs the
        # prior (measured_prior), PRIOR_WEIGHT otherwise
        self.measured = measured
        self.w: Optional[np.ndarray] = None  # [5], unscaled feature space
        self.r2: Optional[float] = None      # of the last fit's probe rows
        self.num_fits = 0

    def prior_weight(self) -> float:
        measured = measured_prior() if self.measured is None \
            else self.measured
        return MEASURED_PRIOR_WEIGHT if measured else PRIOR_WEIGHT

    def fit(self, X: np.ndarray, t: np.ndarray,
            weights: Optional[np.ndarray] = None,
            prior: bool = True) -> float:
        """Fit on measured rows (X [n, 5], t [n]); returns R^2 on those rows.

        With ``prior=True`` the synthesized warm-start rows are appended at
        ``prior_weight()``: they regularize the fit but are excluded from the
        reported R^2, which reflects only how well the model explains its
        own telemetry.
        """
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        t = np.asarray(t, dtype=np.float64)
        n = X.shape[0]
        w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
        Xf, tf, wf = X, t, w
        if prior and n:
            Xf = np.concatenate([X, X], axis=0)
            tf = np.concatenate([t, prior_times(X, self.halo_width,
                                                self.halo_itemsize)])
            wf = np.concatenate([w, np.full(n, self.prior_weight())])
        self.w = _weighted_ridge(Xf, tf, wf, self.ridge)
        self.num_fits += 1
        pred = X @ self.w
        ss_res = float(np.sum(w * (t - pred) ** 2))
        ss_tot = float(np.sum(w * (t - np.average(t, weights=w)) ** 2))
        self.r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
        return self.r2

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Predicted per-part time [n]; the warm-start prior until fit."""
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        if self.w is None:
            return prior_times(X, self.halo_width, self.halo_itemsize)
        return np.maximum(X @ self.w, 0.0)

    def search_weights(self) -> np.ndarray:
        """Weights for the monotone packing search (search.py): negative
        node/edge/halo coefficients (fit noise) clamped to 0 so part cost
        is nondecreasing in the vertex range, the property the parametric
        binary search and the DP both need; the prior's own weights until
        fit."""
        if self.w is None:
            return prior_weights(self.halo_width, self.halo_itemsize)
        w = self.w.copy()
        w[:4] = np.maximum(w[:4], 0.0)
        return w

    def __repr__(self):
        wtxt = None if self.w is None else np.array2string(self.w, precision=3)
        return (f"OnlineCostModel(w={wtxt}, r2={self.r2}, "
                f"fits={self.num_fits})")


def _weighted_ridge(X: np.ndarray, t: np.ndarray, w: np.ndarray,
                    ridge: float) -> np.ndarray:
    """argmin_b sum_i w_i (t_i - X_i b)^2 + ridge |b|^2, column-scaled."""
    scale = np.maximum(np.abs(X).max(axis=0), 1e-12)
    Xs = X / scale
    sw = np.sqrt(w)
    A = Xs * sw[:, None]
    b = t * sw
    n, k = A.shape
    A = np.concatenate([A, np.sqrt(ridge) * np.eye(k)], axis=0)
    b = np.concatenate([b, np.zeros(k)])
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    return sol / scale


assert NUM_FEATURES == 5  # the fixed feature layout this module hardcodes
