"""Hyperparameter sweeps, PyTorch edition.

Port of headpose_tpu/train/sweep.py: the same suggesters on the same
`random.Random` and numpy arithmetic, so a seed gives the JAX package's
candidates.

The reference drives a wandb Bayesian sweep over dropout/regularizer/filters
grids, 50 runs, minimizing test_AFLW2000_mae (Model-96/sweep.yaml:1-13).  This
module runs the same search locally (no service dependency): random search,
full grid, or a real Bayesian optimizer — a Gaussian-process surrogate with
expected-improvement acquisition over the discrete grids, matching wandb's
`method: bayes` capability.  Sweep definitions load from wandb-schema
YAML/JSON files, so the reference's sweep.yaml works as-is.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import random
from typing import Any, Callable

import numpy as np

from .config import TrainConfig

__all__ = ["SweepConfig", "load_sweep_file", "run_sweep", "SweepResult"]


@dataclasses.dataclass
class SweepConfig:
    parameters: dict[str, list[Any]]
    metric: str = "test_aflw2000_mae"
    goal: str = "minimize"
    method: str = "bayes"   # random | grid | bayes
    # None = the method's own default: grid runs the FULL grid (wandb's grid
    # method ignores run caps unless run_cap is set — truncating silently
    # would cover only a biased corner of the product), others run 50
    num_runs: int | None = None
    seed: int = 0
    warmup: int = 8         # random runs before exploit phase (bayes method)

    def resolved_num_runs(self, n_candidates: int) -> int:
        if self.num_runs is not None:
            return self.num_runs
        return n_candidates if self.method == "grid" else 50


def load_sweep_file(path: str) -> SweepConfig:
    """Load a wandb-schema sweep file (method/metric/parameters.values)."""
    if path.endswith((".yaml", ".yml")):
        import yaml
        with open(path) as f:
            raw = yaml.safe_load(f)
    else:
        with open(path) as f:
            raw = json.load(f)
    def coerce(v):
        # the reference sweep.yaml quotes its scientific-notation values
        # ('1e-6'), which YAML keeps as strings — grid values must be numeric
        if isinstance(v, str):
            try:
                return int(v)
            except ValueError:
                try:
                    return float(v)
                except ValueError:
                    return v
        return v

    params = {k: [coerce(x) for x in v["values"]]
              for k, v in raw["parameters"].items()}
    metric = raw.get("metric", {})
    return SweepConfig(
        parameters=params,
        metric=metric.get("name", "test_aflw2000_mae"),
        goal=metric.get("goal", "minimize"),
        method=raw.get("method", "bayes"),
        num_runs=(int(raw["run_cap"]) if "run_cap" in raw
                  else int(raw["num_runs"]) if "num_runs" in raw else None),
    )


@dataclasses.dataclass
class SweepResult:
    runs: list[dict[str, Any]]           # [{params, metrics, objective}]
    best: dict[str, Any]

    def top(self, k: int = 5) -> list[dict[str, Any]]:
        return sorted(self.runs, key=lambda r: r["objective"])[:k]


def _sample_random(rng: random.Random, grids: dict[str, list]) -> dict:
    return {k: rng.choice(v) for k, v in grids.items()}


class _GPSurrogate:
    """Gaussian-process regression over a discrete parameter grid with
    expected-improvement acquisition (the surrogate behind `method: bayes`).

    Configs embed as normalized grid-INDEX vectors (the reference grids are
    ordered magnitude ladders like 0, 1e-6, 1e-4, ..., 0.7, so index space is
    the natural metric — raw values would collapse most of the ladder to 0).
    RBF kernel, unit signal variance on standardized objectives, small jitter
    noise; exact posterior over all (unseen) candidates — the spaces here are
    a few hundred points, so no sparse tricks are needed.
    """

    def __init__(self, grids: dict[str, list], lengthscale: float = 0.35,
                 noise: float = 1e-4):
        self.keys = sorted(grids)
        self.grids = {k: list(grids[k]) for k in self.keys}
        self.lengthscale = lengthscale
        self.noise = noise

    def _embed(self, assignment: dict) -> np.ndarray:
        out = []
        for k in self.keys:
            grid = self.grids[k]
            denom = max(len(grid) - 1, 1)
            out.append(grid.index(assignment[k]) / denom)
        return np.asarray(out)

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / self.lengthscale ** 2)

    def suggest(self, observed: list[tuple[dict, float]],
                candidates: list[dict]) -> dict:
        """Candidate maximizing expected improvement under the GP posterior
        fit to `observed` [(assignment, objective-to-minimize), ...]."""
        X = np.stack([self._embed(a) for a, _ in observed])
        y = np.asarray([v for _, v in observed], np.float64)
        mu0, sd = float(y.mean()), float(y.std()) or 1.0
        y = (y - mu0) / sd
        K = self._kernel(X, X) + self.noise * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, y))
        Xc = np.stack([self._embed(a) for a in candidates])
        Kc = self._kernel(Xc, X)                        # (C, N)
        mean = Kc @ alpha
        v = np.linalg.solve(L, Kc.T)                    # (N, C)
        var = np.maximum(1.0 - (v ** 2).sum(0), 1e-12)
        std = np.sqrt(var)
        best = y.min()
        z = (best - mean) / std
        # expected improvement for minimization, standard-normal cdf/pdf
        cdf = 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))
        pdf = np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
        ei = (best - mean) * cdf + std * pdf
        return candidates[int(np.argmax(ei))]


def run_sweep(sweep: SweepConfig,
              objective_fn: Callable[[dict[str, Any]], dict[str, float]]
              ) -> SweepResult:
    """Run a sweep.  objective_fn maps a parameter assignment to a metrics
    dict containing sweep.metric (typically: build TrainConfig, fit, eval).

    The 'bayes' method matches the reference sweep.yaml's `method: bayes`
    with a real surrogate-model optimizer: `warmup` random configs seed a
    Gaussian process, then each run evaluates the unseen grid point with
    maximum expected improvement (see _GPSurrogate).
    """
    rng = random.Random(sweep.seed)
    sign = 1.0 if sweep.goal == "minimize" else -1.0
    runs: list[dict[str, Any]] = []
    seen: set[tuple] = set()

    keys = sorted(sweep.parameters)
    all_candidates = [dict(zip(keys, vs)) for vs in
                      itertools.product(*(sweep.parameters[k] for k in keys))]
    num_runs = sweep.resolved_num_runs(len(all_candidates))
    plan = all_candidates[:num_runs] if sweep.method == "grid" else None
    gp = _GPSurrogate(sweep.parameters) if sweep.method == "bayes" else None

    def fresh(cand: dict) -> bool:
        return tuple(sorted(cand.items())) not in seen

    for i in range(num_runs):
        if plan is not None:
            if i >= len(plan):
                break
            assignment = plan[i]
        else:
            if len(seen) >= len(all_candidates):
                break  # grid exhausted: duplicates would burn full runs
            if gp is not None and i >= sweep.warmup and runs:
                unseen = [c for c in all_candidates if fresh(c)]
                assignment = gp.suggest(
                    [(r["params"], r["objective"]) for r in runs], unseen)
            else:
                assignment = None
                for _ in range(256):
                    cand = _sample_random(rng, sweep.parameters)
                    if fresh(cand):
                        assignment = cand
                        break
                if assignment is None:
                    continue

        key = tuple(sorted(assignment.items()))
        seen.add(key)

        metrics = objective_fn(assignment)
        objective = sign * float(metrics[sweep.metric])
        runs.append({"params": assignment, "metrics": metrics,
                     "objective": objective})

    best = min(runs, key=lambda r: r["objective"])
    return SweepResult(runs=runs, best=best)
