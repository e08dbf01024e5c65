"""Standard target posteriors for tests and benchmarks.

Fully jittable log-likelihood / log-prior pairs written against the
``samples.x`` contract (reference README.md:46-52). These mirror the
reference's example problems (examples/basic_example.py,
examples/smc_example.py) plus the BASELINE.json benchmark configs
(Rosenbrock, d=32 hierarchical) and Neal's funnel.

Each problem exposes ``log_likelihood(samples)``, ``log_prior(samples)``,
``dims``, optional ``prior_bounds``, ``true_log_evidence`` (when
analytic), and ``draw_initial_samples(rng, n)`` for generating the
"existing posterior samples" the framework reuses.
"""

from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class Problem:
    dims: int

    @property
    def parameters(self) -> list[str]:
        return [f"x_{i}" for i in range(self.dims)]

    prior_bounds = None
    true_log_evidence = None

    def log_likelihood(self, samples):
        raise NotImplementedError

    def log_prior(self, samples):
        raise NotImplementedError

    def draw_initial_samples(self, rng, n: int) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass
class GaussianProblem(Problem):
    """N(mu, sigma) likelihood x U(lower, upper)^d prior.

    Parity: reference examples/basic_example.py — with the defaults,
    ``true_log_evidence = -dims * log(20)``.
    """

    dims: int = 4
    mu: float = 2.0
    sigma: float = 1.0
    lower: float = -10.0
    upper: float = 10.0

    @property
    def prior_bounds(self):
        return {p: [self.lower, self.upper] for p in self.parameters}

    @property
    def true_log_evidence(self):
        return -self.dims * math.log(self.upper - self.lower)

    def log_likelihood(self, samples):
        x = samples.x
        return jnp.sum(
            -0.5 * ((x - self.mu) / self.sigma) ** 2
            - 0.5 * jnp.log(2 * jnp.pi * self.sigma**2),
            axis=-1,
        )

    def log_prior(self, samples):
        x = samples.x
        inside = jnp.all((x >= self.lower) & (x <= self.upper), axis=-1)
        log_p = -self.dims * jnp.log(self.upper - self.lower)
        return jnp.where(inside, log_p, -jnp.inf)

    def draw_initial_samples(self, rng, n: int) -> np.ndarray:
        # Slightly biased w.r.t. the true posterior, as in the example.
        return rng.normal(self.mu + 0.5, self.sigma, size=(n, self.dims))


@dataclasses.dataclass
class GaussianMixtureProblem(Problem):
    """Two-Gaussian mixture likelihood x standard-normal prior.

    Parity: reference examples/smc_example.py:37-57.
    """

    dims: int = 4
    separation: float = 2.0

    def __post_init__(self):
        d = self.dims
        self.mu1 = self.separation * np.ones(d)
        self.mu2 = -self.separation * np.ones(d)
        self.var1 = 0.5
        self.var2 = 1.0

    @property
    def true_log_evidence(self):
        """Under the N(0, I) prior each component integrates to
        N(mu; 0, (var + 1) I), so Z is their equal-weight mixture."""
        d = self.dims

        def log_normal_at_zero(mu, var):
            return -0.5 * np.sum(mu**2) / var - 0.5 * d * np.log(
                2 * np.pi * var
            )

        return float(
            np.logaddexp(
                log_normal_at_zero(self.mu1, self.var1 + 1.0),
                log_normal_at_zero(self.mu2, self.var2 + 1.0),
            )
            - np.log(2.0)
        )

    def log_likelihood(self, samples):
        x = samples.x
        d = self.dims
        comp1 = (
            -0.5 * jnp.sum((x - self.mu1) ** 2, axis=-1) / self.var1
            - 0.5 * d * jnp.log(2 * jnp.pi)
            - 0.5 * d * jnp.log(self.var1)
        )
        comp2 = (
            -0.5 * jnp.sum((x - self.mu2) ** 2, axis=-1) / self.var2
            - 0.5 * d * jnp.log(2 * jnp.pi)
            - 0.5 * d * jnp.log(self.var2)
        )
        return jnp.logaddexp(comp1, comp2) - jnp.log(2.0)

    def log_prior(self, samples):
        x = samples.x
        return -0.5 * jnp.sum(x**2, axis=-1) - 0.5 * self.dims * jnp.log(
            2 * jnp.pi
        )

    def draw_initial_samples(self, rng, n: int) -> np.ndarray:
        offset_1 = rng.uniform(-3, 3, size=(self.dims,))
        offset_2 = rng.uniform(-3, 3, size=(self.dims,))
        return np.concatenate(
            [
                rng.normal(self.mu1 - offset_1, 1, size=(n // 2, self.dims)),
                rng.normal(
                    self.mu2 - offset_2, 1, size=(n - n // 2, self.dims)
                ),
            ],
            axis=0,
        )


@dataclasses.dataclass
class RosenbrockProblem(Problem):
    """Rosenbrock likelihood x uniform prior (BASELINE.json config 4)."""

    dims: int = 2
    lower: float = -5.0
    upper: float = 5.0

    @property
    def prior_bounds(self):
        return {p: [self.lower, self.upper] for p in self.parameters}

    def log_likelihood(self, samples):
        x = samples.x
        return -jnp.sum(
            100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
            + (1 - x[..., :-1]) ** 2,
            axis=-1,
        )

    def log_prior(self, samples):
        x = samples.x
        inside = jnp.all((x >= self.lower) & (x <= self.upper), axis=-1)
        log_p = -self.dims * jnp.log(self.upper - self.lower)
        return jnp.where(inside, log_p, -jnp.inf)

    def draw_initial_samples(self, rng, n: int) -> np.ndarray:
        x0 = rng.normal(1.0, 1.0, size=(n, 1))
        cols = [x0]
        for _ in range(self.dims - 1):
            cols.append(cols[-1] ** 2 + rng.normal(0, 0.5, size=(n, 1)))
        x = np.concatenate(cols, axis=1)
        return np.clip(x, self.lower + 0.1, self.upper - 0.1)


@dataclasses.dataclass
class FunnelProblem(Problem):
    """Neal's funnel as a likelihood x wide-normal prior."""

    dims: int = 10
    scale: float = 3.0
    #: scale of the wide-normal prior; referenced by the analytic
    #: evidence quadrature in benchmarks/validate.py — keep in sync.
    prior_scale: float = 10.0

    def log_likelihood(self, samples):
        x = samples.x
        v = x[..., 0]
        rest = x[..., 1:]
        log_p_v = -0.5 * (v / self.scale) ** 2 - 0.5 * jnp.log(
            2 * jnp.pi * self.scale**2
        )
        d = self.dims - 1
        log_p_rest = (
            -0.5 * jnp.sum(rest**2, axis=-1) * jnp.exp(-v)
            - 0.5 * d * (jnp.log(2 * jnp.pi) + v)
        )
        return log_p_v + log_p_rest

    def log_prior(self, samples):
        x = samples.x
        s = self.prior_scale
        return jnp.sum(
            -0.5 * (x / s) ** 2 - 0.5 * jnp.log(2 * jnp.pi * s**2), axis=-1
        )

    def draw_initial_samples(self, rng, n: int) -> np.ndarray:
        v = rng.normal(0, self.scale, size=(n, 1))
        rest = rng.normal(size=(n, self.dims - 1)) * np.exp(v / 2)
        return np.concatenate([v, rest], axis=1)


@dataclasses.dataclass
class HierarchicalProblem(Problem):
    """d-dimensional hierarchical Gaussian posterior (BASELINE config 5).

    A global mean ``m`` and log-scale ``s`` with per-group effects:
    x = [m, s, theta_1..theta_{d-2}]; observations y_i ~ N(theta_i, 1),
    theta_i ~ N(m, exp(s)).
    """

    dims: int = 32
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.y_obs = rng.normal(1.0, 1.2, size=(self.dims - 2,))

    def log_likelihood(self, samples):
        x = samples.x
        theta = x[..., 2:]
        return jnp.sum(
            -0.5 * (self.y_obs - theta) ** 2 - 0.5 * jnp.log(2 * jnp.pi),
            axis=-1,
        )

    def log_prior(self, samples):
        x = samples.x
        m, s, theta = x[..., 0], x[..., 1], x[..., 2:]
        scale = jnp.exp(s)
        log_p_m = -0.5 * (m / 5.0) ** 2 - 0.5 * jnp.log(2 * jnp.pi * 25.0)
        log_p_s = -0.5 * (s / 1.0) ** 2 - 0.5 * jnp.log(2 * jnp.pi)
        log_p_theta = jnp.sum(
            -0.5 * ((theta - m[..., None]) / scale[..., None]) ** 2
            - jnp.log(scale[..., None])
            - 0.5 * jnp.log(2 * jnp.pi),
            axis=-1,
        )
        return log_p_m + log_p_s + log_p_theta

    def draw_initial_samples(self, rng, n: int) -> np.ndarray:
        m = rng.normal(1.0, 0.5, size=(n, 1))
        s = rng.normal(0.0, 0.3, size=(n, 1))
        theta = rng.normal(
            self.y_obs, 1.0, size=(n, self.dims - 2)
        )
        return np.concatenate([m, s, theta], axis=1)


_PROBLEMS = {
    "gaussian": GaussianProblem,
    "gaussian_mixture": GaussianMixtureProblem,
    "rosenbrock": RosenbrockProblem,
    "funnel": FunnelProblem,
    "hierarchical": HierarchicalProblem,
}


def get_problem(name: str, **kwargs) -> Problem:
    try:
        return _PROBLEMS[name.lower()](**kwargs)
    except KeyError:
        raise ValueError(
            f"Unknown problem '{name}'. Choose from {sorted(_PROBLEMS)}"
        ) from None
