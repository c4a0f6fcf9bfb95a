"""Oracle and Regularizer base classes.

Port of ``krylov_crn_tpu/models/base.py`` (the reference's oracle surface,
loss.py:29-159): the running-best (f_opt, x_opt) record inside ``value``
(loss.py:66-73, which the empirical f* protocol depends on), a seeded RNG,
the static vector helpers, and an l1/l2 regularizer with proximal
operators. Vectors may be numpy arrays or tensors; the helpers work on
tensors.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

__all__ = ["Oracle", "Regularizer"]


def _t(x):
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


class Regularizer:
    """l1 + l2/2 regularizer with proximal operator (reference
    loss.py:116-159), on dense vectors."""

    def __init__(self, l1=0.0, l2=0.0, coef=None):
        self.l1 = float(l1)
        self.l2 = float(l2)
        self.coef = coef

    def __call__(self, x):
        return self.value(x)

    def value(self, x):
        x = _t(x)
        v = 0.0
        if self.l1:
            v = v + self.l1 * torch.sum(torch.abs(x))
        if self.l2:
            v = v + self.l2 / 2.0 * torch.dot(x, x)
        return v

    def prox_l1(self, x, lr):
        x = _t(x)
        a = torch.abs(x)
        return torch.sign(x) * (a - torch.clamp(a, max=self.l1 * lr))

    def prox_l2(self, x, lr):
        return _t(x) / (1.0 + lr * self.l2)

    def prox(self, x, lr):
        return self.prox_l2(self.prox_l1(x, lr), lr)


class Oracle:
    """Base objective. Subclasses provide ``_value`` and the derivatives."""

    def __init__(self, l1=0.0, l2=0.0, l2_in_prox=False, regularizer=None,
                 seed=42):
        if l1 < 0.0:
            raise ValueError(f"Invalid value for l1 regularization: {l1}")
        if l2 < 0.0:
            raise ValueError(f"Invalid value for l2 regularization: {l2}")
        if l2 == 0.0 and l2_in_prox:
            warnings.warn("The value of l2 is set to 0, so l2_in_prox is "
                          "changed to False.")
            l2_in_prox = False
        self.l1 = float(l1)
        self.l2 = 0.0 if l2_in_prox else float(l2)
        self.l2_in_prox = l2_in_prox
        self.x_opt = None
        self.f_opt = np.inf
        self.regularizer = regularizer
        self.seed = seed
        if (l1 > 0 or l2_in_prox) and regularizer is None:
            self.regularizer = Regularizer(l1=l1,
                                           l2=l2 if l2_in_prox else 0.0)
        self.rng = np.random.default_rng(seed)

        self._smoothness = None
        self._max_smoothness = None
        self._ave_smoothness = None
        self._hessian_lipschitz = None

    def set_seed(self, seed):
        self.seed = seed
        self.rng = np.random.default_rng(seed)

    def _value(self, x):  # pragma: no cover - abstract
        raise NotImplementedError

    def value(self, x):
        """Objective value with running-best tracking (loss.py:66-73)."""
        value = self._value(x)
        if self.regularizer is not None:
            value = value + self.regularizer(x)
        value = float(value)
        if value < self.f_opt:
            self.x_opt = _t(x).clone()
            self.f_opt = value
        return value

    def reset(self):
        """Drop cached per-iterate state (subclasses with caches)."""

    # --- static vector helpers ------------------------------------------
    @staticmethod
    def norm(x):
        return float(torch.linalg.norm(_t(x)))

    @staticmethod
    def inner_prod(x, y):
        return float(torch.dot(_t(x), _t(y)))

    @staticmethod
    def outer_prod(x, y):
        return torch.outer(_t(x), _t(y))

    @staticmethod
    def is_equal(x, y):
        if x is None:
            return y is None
        if y is None:
            return False
        x, y = _t(x), _t(y)
        if x.shape != y.shape:
            return False
        return bool(torch.equal(x, y.to(x.device, x.dtype)))
