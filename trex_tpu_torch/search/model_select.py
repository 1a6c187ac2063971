"""Substitution-model selection by information criteria (AIC / AICc / BIC)
(counterpart of ``trex_tpu/search/model_select.py``).

Each candidate model is fitted on a fixed topology with
``ops.likelihood.optimize_model`` and the fits are ranked by the requested
criterion. Parameters are counted by the unrooted-tree convention: 2n - 3
branch lengths (the rooted parameterization has one redundant
root-adjacent length under reversible models), plus per model:

- jc: 0; k80: 1 (kappa); hky: 1 + (Q - 1); f81: Q - 1; tn93: 2 + (Q - 1)
- gtr: Q(Q - 1)/2 - 1 exchangeabilities + Q - 1 frequencies
- empirical (fixed matrix): 0 (Q - 1 when the frequencies are fitted)
- +g: 1 (Gamma shape); +i: 1 (invariant share)
- +rK: 2K - 2 (K rates and K weights less two normalisations)
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

from trex_tpu_torch.topology import Topology


@dataclass
class ModelFit:
    model: str
    log_likelihood: float
    n_parameters: int
    aic: float
    aicc: float
    bic: float
    params: dict


def count_parameters(model: str, n_states: int, n_leaves: int,
                     freqs_fitted: bool = False) -> int:
    """Free-parameter count of a model string (see the module docstring)."""
    m = re.fullmatch(
        r"(jc|k80|hky|f81|tn93|gtr|empirical)(?:(\+g)?(\+i)?|(\+r([2-8])))?", model)
    if not m:
        raise ValueError(f"unknown model {model!r}")
    k = 2 * n_leaves - 3  # unrooted branch lengths
    q = n_states
    base = m.group(1)
    if base == "gtr":
        k += q * (q - 1) // 2 - 1 + (q - 1)
    elif base == "empirical" and freqs_fitted:
        k += q - 1
    elif base == "k80":
        k += 1
    elif base == "hky":
        k += 1 + (q - 1)
    elif base == "f81":
        k += q - 1
    elif base == "tn93":
        k += 2 + (q - 1)
    if m.group(2):
        k += 1
    if m.group(3):
        k += 1
    if m.group(5):
        k += 2 * int(m.group(5)) - 2
    return k


def compare_models(
    topology: Topology,
    leaf_sequences,
    n_states: int,
    *,
    models: tuple[str, ...] = ("jc", "jc+g", "gtr", "gtr+g", "gtr+g+i", "gtr+r3"),
    criterion: str = "bic",
    site_weights=None,
    sequences_are_masks: bool = False,
    n_iterations: int = 500,
    learning_rate: float = 0.05,
    fixed_rates=None,
    fixed_freqs=None,
    timings: dict | None = None,
) -> list[ModelFit]:
    """Fit every candidate model on the fixed topology (on the device of
    ``leaf_sequences``) and return the fits sorted best first by
    ``criterion`` ("aic", "aicc" or "bic"). ``site_weights`` (compressed
    patterns) are exact: the sample size of AICc and BIC is their sum.
    ``timings``: a dict that, when given, maps each model to its fit's
    wall seconds (the device synchronized before the clock is read)."""
    import time

    from trex_tpu_torch.ops.likelihood import optimize_model

    if criterion not in ("aic", "aicc", "bic"):
        raise ValueError(f"unknown criterion {criterion!r}")
    leaves = torch.as_tensor(leaf_sequences)
    n_sites = (
        float(torch.as_tensor(site_weights).sum()) if site_weights is not None
        else float(leaves.shape[-1])
    )
    n_leaves = topology.n_leaves
    topology = topology.to(leaves.device)
    fits: list[ModelFit] = []
    for model in models:
        clock = time.perf_counter()
        params, losses = optimize_model(
            topology, leaves, n_states, model=model, n_iterations=n_iterations,
            learning_rate=learning_rate, sequences_are_masks=sequences_are_masks,
            site_weights=site_weights, fixed_rates=fixed_rates, fixed_freqs=fixed_freqs,
        )
        lnl = -float(losses[-1])
        if timings is not None:
            timings[model] = time.perf_counter() - clock
        k = count_parameters(
            model, n_states, n_leaves,
            freqs_fitted=model.startswith("empirical") and fixed_freqs is None,
        )
        aic = 2.0 * k - 2.0 * lnl
        denom = n_sites - k - 1.0
        aicc = aic + (2.0 * k * (k + 1.0) / denom if denom > 0 else np.inf)
        bic = k * np.log(n_sites) - 2.0 * lnl
        fits.append(ModelFit(
            model=model, log_likelihood=lnl, n_parameters=k, aic=aic, aicc=aicc, bic=bic,
            params={key: None if value is None else value.cpu().numpy()
                    for key, value in params.items()},
        ))
    return sorted(fits, key=lambda f: getattr(f, criterion))
