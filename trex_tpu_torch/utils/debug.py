"""Numerical-debug switch (counterpart of ``trex_tpu/utils/debug.py``)."""

from __future__ import annotations

import torch


def enable_nan_checks(enable: bool = True) -> None:
    """Switch PyTorch's autograd anomaly detection on or off globally (slow;
    for debugging runs).

    What it checks: every backward function's outputs, raising at the
    first gradient with a NaN, with the traceback of the forward operation
    that made it. What JAX's ``jax_debug_nans`` and ``jax_debug_infs``
    (the JAX package's switch) check that it does not: the forward results
    of every operation, outside autograd too (a NaN in a likelihood, a
    kernel's output, a host-side fit), and infinities anywhere; a forward
    NaN shows here only once a gradient carries it.
    """
    torch.autograd.set_detect_anomaly(enable)
