"""Sample containers.

Single-namespace data model replacing the reference's xp-polymorphic dataclasses
(``/root/reference/src/aspire/samples.py``). All arrays are JAX arrays in a
single namespace; conversion happens only at I/O and plotting boundaries.
The hot path inside samplers operates on plain JAX arrays (see
:mod:`aspire_tpu.samplers.smc`); these classes are the user-facing API:

- :class:`BaseSamples`  — x, log_likelihood, log_prior, log_q (reference
  samples.py:36-413)
- :class:`Samples`      — importance weights, evidence, ESS (417-595)
- :class:`MCMCSamples`  — chain-shaped samples + burn-in/thin (599-806)
- :class:`PTMCMCSamples`— parallel-tempered chains + thermodynamic
  integration / stepping-stone evidence (810-1205)
- :class:`SMCSamples`   — tempered particles; incremental weights,
  per-step evidence ratio, on-device resampling (1209-1333)
"""

from __future__ import annotations

import dataclasses
import math
from copy import deepcopy
from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .ops.resampling import get_resampler
from .ops.special import effective_sample_size, logsumexp
from .utils import asarray, resolve_dtype, to_numpy
import functools


def incremental_log_weights(log_q, log_likelihood, log_prior, beta_prev, beta):
    """Tempered-path incremental weights with the NaN guard.

    Single source of truth for
    ``(beta_prev - beta) log_q + (beta - beta_prev)(logL + logPi)``
    (reference samples.py:1221-1249) — used by the jitted resample, the
    ring collective, and the device ladder.
    """
    log_w = (beta_prev - beta) * log_q + (beta - beta_prev) * (
        log_likelihood + log_prior
    )
    return jnp.where(jnp.isnan(log_w), -jnp.inf, log_w)


@functools.partial(jax.jit, static_argnames=("n_samples", "method"))
def _resample_on_device(
    key,
    log_w,
    x,
    log_likelihood,
    log_prior,
    log_q,
    *,
    n_samples: int,
    method: str,
):
    """Resampling indices from ``log_w`` -> gathers, in one jit."""
    idx = get_resampler(method)(key, log_w, n_samples)
    return x[idx], log_likelihood[idx], log_prior[idx], log_q[idx]

import logging

logger = logging.getLogger("aspire_tpu")


# ---------------------------------------------------------------------------
# Tempered-ladder evidence reductions (thermodynamic integration and
# stepping stone). Both are single jitted reductions over the full
# (n_rungs, n_samples) log-likelihood matrix, ordered cold -> hot is NOT
# assumed: callers pass betas ascending (prior at index 0, posterior last).
#
# Error bars use the delta method with an effective sample size
# n / tau per rung, where tau is the integrated autocorrelation time of
# the rung's log-likelihood series — chains that mix poorly report
# honestly wider errors instead of the iid-sample fiction.
# ---------------------------------------------------------------------------


@jax.jit
def _trapezoid_weights(betas):
    """Node weights w with ``w @ f == jnp.trapezoid(f, betas)``."""
    gaps = jnp.diff(betas)
    w = jnp.zeros_like(betas)
    w = w.at[:-1].add(0.5 * gaps)
    w = w.at[1:].add(0.5 * gaps)
    return w


# Both reductions take the log-likelihood matrix CENTERED per rung
# (the f64 rung means are carried on the host): real problems have
# |logL| ~ 1e6 where a device f32 cast would cost ~0.06 absolute per
# element, while the centered spreads are small and f32-safe. The
# O(T)-sized mean terms are recombined in f64 outside jit.


@jax.jit
def _ti_spread_error(betas, logl_centered, tau):
    """Delta-method TI quadrature error from centered draws.

    Rungs are independent chains, so
    ``Var(logZ) = sum_t w_t^2 Var(mean logL_t)`` with the per-rung mean
    variance deflated by the effective sample count ``S / tau_t``.
    Shift-invariant: centering does not change any variance.
    """
    w = _trapezoid_weights(betas)
    n_eff = logl_centered.shape[1] / tau
    var_of_mean = jnp.var(logl_centered, axis=1) / n_eff
    return jnp.sqrt(jnp.sum(jnp.square(w) * var_of_mean))


@jax.jit
def _stepping_stone_reduce(betas, logl_centered, tau):
    """Stepping-stone over centered draws.

    ``log r_j = log E_{beta_j}[ L^{dbeta_j} ]``, estimated from the
    hotter rung ``j`` with a max-shifted mean-exp; centering only
    removes the (exactly known) ``dbeta_j * mean_j`` base term, which
    the caller adds back in f64. All rungs reduce at once: (T-1, S)
    shifted integrand, one vmap-free pass.

    Error: delta method per rung,
    ``Var(log r_j) ≈ relvar(g_j) / n_eff_j`` with
    ``relvar = Var(g)/mean(g)^2``, summed over rungs (independent
    chains) — also shift-invariant.
    """
    gaps = jnp.diff(betas)  # (T-1,)
    a = gaps[:, None] * logl_centered[:-1]  # hotter rung powers the ratio
    shift = jnp.max(a, axis=1, keepdims=True)
    # An all-(-inf) rung makes shift = -inf and a - shift = NaN;
    # shifting by 0 instead keeps the row at -inf so the rung
    # contributes an honest -inf ratio (same guard as logsumexp).
    shift = jnp.where(jnp.isfinite(shift), shift, 0.0)
    # The clip is a no-op in exact arithmetic (a <= shift) but blocks
    # XLA from reassociating exp(a - shift) into an overflowing form —
    # observed as logZ = +-inf on a funnel prior rung whose logL spans
    # 1e19 (jit gave inf where eager was finite).
    g = jnp.exp(jnp.minimum(a - shift, 0.0))
    g_mean = jnp.mean(g, axis=1)
    log_r = jnp.log(g_mean) + jnp.squeeze(shift, axis=1)
    n_eff = logl_centered.shape[1] / tau[:-1]
    rel_var = jnp.var(g, axis=1) / (n_eff * jnp.square(g_mean))
    return jnp.sum(log_r), jnp.sqrt(jnp.sum(rel_var))


def _integrated_autocorr_1d(series: np.ndarray, c: float = 5.0) -> float:
    """Sokal-windowed IAT of a ``(n_steps, n_chains)`` scalar series.

    Returns 1.0 for degenerate (constant / too-short) series so callers
    can use it directly as an ESS deflator.
    """
    series = np.asarray(series, dtype=np.float64)
    n = series.shape[0]
    if n < 4:
        return 1.0
    centered = series - series.mean(axis=0, keepdims=True)
    nfft = 1 << (2 * n - 1).bit_length()
    spec = np.fft.rfft(centered, n=nfft, axis=0)
    acf = np.fft.irfft(spec * np.conjugate(spec), n=nfft, axis=0)[:n].real
    acf = acf.mean(axis=1)
    if not np.isfinite(acf[0]) or acf[0] <= 0:
        return 1.0
    rho = acf / acf[0]
    tau_running = 2.0 * np.cumsum(rho) - 1.0
    window = np.nonzero(np.arange(n) >= c * tau_running)[0]
    tau = tau_running[window[0]] if window.size else tau_running[-1]
    return float(max(tau, 1.0))

Array = Any


def _maybe(fn, value):
    return fn(value) if value is not None else None


@dataclass
class BaseSamples:
    """Samples ``x`` of shape ``(n, d)`` with log-density annotations."""

    x: Array
    log_likelihood: Array | None = None
    log_prior: Array | None = None
    log_q: Array | None = None
    parameters: list[str] | None = None
    dtype: Any = None

    def __post_init__(self):
        self.dtype = resolve_dtype(self.dtype)
        self.x = asarray(self.x, dtype=self.dtype)
        if self.x.ndim == 1:
            self.x = self.x[:, None]
        if self.dtype is None:
            self.dtype = self.x.dtype
            if not jnp.issubdtype(self.dtype, jnp.floating):
                # Integer positions must not drag the log-densities
                # down to an integer dtype (silent truncation); adopt
                # the default float instead (honors enable_x64).
                self.dtype = jnp.zeros((), dtype=float).dtype
                self.x = asarray(self.x, dtype=self.dtype)
        self.log_likelihood = _maybe(
            lambda v: asarray(v, dtype=self.dtype).reshape(-1),
            self.log_likelihood,
        )
        self.log_prior = _maybe(
            lambda v: asarray(v, dtype=self.dtype).reshape(-1), self.log_prior
        )
        self.log_q = _maybe(
            lambda v: asarray(v, dtype=self.dtype).reshape(-1), self.log_q
        )
        if self.parameters is None:
            self.parameters = [f"x_{i}" for i in range(self.dims)]
        else:
            self.parameters = list(self.parameters)

    # -- basic protocol ----------------------------------------------------

    @property
    def dims(self) -> int:
        if self.x is None:
            return 0
        return self.x.shape[1] if self.x.ndim > 1 else 1

    def __len__(self) -> int:
        return len(self.x)

    def __getitem__(self, idx) -> "BaseSamples":
        return self.__class__(
            x=self.x[idx],
            log_likelihood=_maybe(lambda v: v[idx], self.log_likelihood),
            log_prior=_maybe(lambda v: v[idx], self.log_prior),
            log_q=_maybe(lambda v: v[idx], self.log_q),
            parameters=self.parameters,
            dtype=self.dtype,
        )

    def __setitem__(self, idx, value):
        raise NotImplementedError("Setting items is not supported")

    def __str__(self) -> str:
        return (
            f"No. samples: {len(self.x)}\n"
            f"No. parameters: {self.x.shape[-1]}\n"
        )

    # -- conversion --------------------------------------------------------

    def to_dict(self, flat: bool = True, copy: bool = True) -> dict:
        """Dict representation; per-parameter columns (reference :142)."""
        out = {}
        for f in dataclasses.fields(self):
            name = f.name
            if name == "x":
                continue
            value = getattr(self, name)
            if copy:
                try:
                    value = deepcopy(value)
                except Exception:
                    pass
            out[name] = value
        columns = dict(zip(self.parameters, self.x.T, strict=True))
        if flat:
            out.update(columns)
        else:
            out["samples"] = columns
        return out

    @classmethod
    def from_dict(cls, dictionary: dict) -> "BaseSamples":
        dictionary = dict(dictionary)
        if "samples" in dictionary:
            samples = dictionary.pop("samples")
            parameters = dictionary.pop("parameters", None)
            if parameters is None:
                parameters = sorted(samples.keys())
            x = np.stack([np.asarray(samples[p]) for p in parameters], axis=-1)
        else:
            parameters = dictionary.pop("parameters", None)
            if parameters is None:
                raise ValueError(
                    "Parameters must be provided if samples are not nested "
                    "in a 'samples' key"
                )
            x = np.stack(
                [np.asarray(dictionary.pop(p)) for p in parameters], axis=-1
            )
        known = {f.name for f in dataclasses.fields(cls)}
        init_fields = {
            f.name for f in dataclasses.fields(cls) if f.init
        }
        kwargs = {
            k: v
            for k, v in dictionary.items()
            if k in known and k in init_fields
        }
        return cls(x=x, parameters=list(parameters), **kwargs)

    def to_dataframe(self, include: list[str] | None = None):
        import pandas as pd

        data = {
            p: to_numpy(col)
            for p, col in zip(self.parameters, self.x.T, strict=True)
        }
        if include is None:
            include = ["log_likelihood", "log_prior", "log_q"]
        n = len(self.x)
        for key in include:
            value = getattr(self, key, None)
            data[key] = (
                to_numpy(value) if value is not None else np.full(n, np.nan)
            )
        return pd.DataFrame(data)

    def to_numpy(self) -> "BaseSamples":
        """Host copy of the samples (numpy arrays) for I/O and plotting."""
        out = deepcopy(self)
        for f in dataclasses.fields(self):
            value = getattr(out, f.name)
            if isinstance(value, jax.Array):
                setattr(out, f.name, to_numpy(value))
        return out

    # -- persistence -------------------------------------------------------

    def _encode_for_hdf5(self, flat: bool = True) -> dict:
        host = self.to_numpy()
        dictionary = host.to_dict(flat=flat)
        dictionary["dtype"] = str(np.dtype(self.dtype))
        dictionary["__class__"] = type(self).__name__
        return dictionary

    def save(self, h5_file, path: str = "samples", flat: bool = False):
        from .io import save_dict_to_hdf5

        save_dict_to_hdf5(h5_file, path, self._encode_for_hdf5(flat=flat))

    @classmethod
    def load(cls, h5_file, path: str = "samples") -> "BaseSamples":
        from .io import load_dict_from_hdf5

        dictionary = load_dict_from_hdf5(h5_file, path)
        dictionary.pop("__class__", None)
        return cls.from_dict(dictionary)

    # -- construction helpers ---------------------------------------------

    @classmethod
    def concatenate(cls, samples: list["BaseSamples"]) -> "BaseSamples":
        if not samples:
            raise ValueError("No samples to concatenate")
        if not all(s.parameters == samples[0].parameters for s in samples):
            raise ValueError("Parameters do not match")
        if not all(s.dtype == samples[0].dtype for s in samples):
            raise ValueError("Dtypes do not match")

        def cat(name):
            values = [getattr(s, name) for s in samples]
            if any(v is None for v in values):
                return None
            return jnp.concatenate(values, axis=0)

        return cls(
            x=cat("x"),
            log_likelihood=cat("log_likelihood"),
            log_prior=cat("log_prior"),
            log_q=cat("log_q"),
            parameters=samples[0].parameters,
            dtype=samples[0].dtype,
        )

    @classmethod
    def from_samples(cls, samples: "BaseSamples", **kwargs) -> "BaseSamples":
        kwargs.setdefault("dtype", samples.dtype)
        kwargs.setdefault("parameters", samples.parameters)
        return cls(
            x=samples.x,
            log_likelihood=samples.log_likelihood,
            log_prior=samples.log_prior,
            log_q=samples.log_q,
            **kwargs,
        )

    # -- plotting ----------------------------------------------------------

    def plot_corner(self, parameters: list[str] | None = None, fig=None, **kwargs):
        kwargs = deepcopy(kwargs)
        kwargs.setdefault("labels", self.parameters)
        if parameters is not None:
            indices = [self.parameters.index(p) for p in parameters]
            kwargs["labels"] = parameters
            x = self.x[:, indices]
        else:
            x = self.x
        try:
            import corner

            return corner.corner(to_numpy(x), fig=fig, **kwargs)
        except ImportError:
            from .plot import corner_plot

            return corner_plot(to_numpy(x), fig=fig, **kwargs)


@dataclass
class Samples(BaseSamples):
    """Weighted (importance) samples. Parity: reference samples.py:417-595."""

    log_evidence: float | None = None
    log_evidence_error: float | None = None
    log_w: Array = field(init=False, default=None)
    weights: Array = field(init=False, default=None)
    evidence: Array = field(init=False, default=None)
    evidence_error: Array = field(init=False, default=None)
    effective_sample_size: Array = field(init=False, default=None)

    def __post_init__(self):
        super().__post_init__()
        if all(
            v is not None
            for v in (self.log_likelihood, self.log_prior, self.log_q)
        ):
            self.compute_weights()

    def compute_weights(self) -> None:
        """log_w = logL + logPi - log_q; evidence + delta-method error + ESS.

        Parity: reference ``Samples.compute_weights`` (samples.py:457-475).
        """
        self.log_w = self.log_likelihood + self.log_prior - self.log_q
        n = len(self.x)
        self.log_evidence = logsumexp(self.log_w) - math.log(n)
        self.weights = jnp.exp(self.log_w)
        self.evidence = jnp.exp(self.log_evidence)
        # Delta-method relative error computed in max-shifted space: the
        # raw form (weights - evidence)**2 underflows f32 whenever
        # |logZ| >~ 44, silently reporting zero error. The shift cancels
        # in the ratio sigma_Z / Z.
        # n*(n-1) as a float: the int product overflows int32 for n >= 2^16.
        m = jnp.max(self.log_w)
        u = jnp.exp(jnp.minimum(self.log_w - m, 0.0))
        u_mean = jnp.mean(u)
        sigma_u = jnp.sqrt(jnp.sum((u - u_mean) ** 2) / (n * (n - 1.0)))
        self.log_evidence_error = jnp.where(
            u_mean > 0, sigma_u / u_mean, jnp.inf
        )
        self.evidence_error = self.log_evidence_error * self.evidence
        self.effective_sample_size = effective_sample_size(
            self.log_w - jnp.max(self.log_w)
        )

    @property
    def efficiency(self):
        if self.log_w is None:
            raise RuntimeError("Samples do not contain weights!")
        return self.effective_sample_size / len(self.x)

    @property
    def scaled_weights(self):
        return jnp.exp(self.log_w - jnp.max(self.log_w))

    def rejection_sample(self, key: jax.Array | None = None, rng=None):
        """Rejection-sample to unweighted samples (reference :481-494)."""
        n = len(self.x)
        if key is not None:
            log_u = jnp.log(jax.random.uniform(key, (n,)))
        else:
            rng = rng or np.random.default_rng()
            log_u = jnp.asarray(np.log(rng.uniform(size=n)))
        log_w = self.log_w - jnp.max(self.log_w)
        # The accept mask stays on device: eager boolean indexing of a
        # jax array compacts on-device (the output shape is data-
        # dependent, so this path is host-driven but never round-trips
        # the mask or the population through numpy).
        accept = log_w > log_u
        return self.__class__(
            x=self.x[accept],
            log_likelihood=self.log_likelihood[accept],
            log_prior=self.log_prior[accept],
            dtype=self.dtype,
            parameters=self.parameters,
        )

    def plot_corner(self, include_weights: bool = True, **kwargs):
        kwargs = deepcopy(kwargs)
        if (
            include_weights
            and self.weights is not None
            and "weights" not in kwargs
        ):
            kwargs["weights"] = to_numpy(self.scaled_weights)
        return super().plot_corner(**kwargs)

    def __getitem__(self, idx):
        sliced = super().__getitem__(idx)
        sliced.log_evidence = self.log_evidence
        sliced.log_evidence_error = self.log_evidence_error
        return sliced

    def __str__(self):
        out = super().__str__()
        if self.log_evidence is not None:
            out += f"Log evidence: {float(self.log_evidence):.2f}"
            if self.log_evidence_error is not None:
                out += f" +/- {float(self.log_evidence_error):.2f}"
            out += "\n"
        if self.log_w is not None:
            out += (
                f"Effective sample size: "
                f"{float(self.effective_sample_size):.1f}\n"
                f"Efficiency: {float(self.efficiency):.2f}\n"
            )
        return out


@dataclass
class MCMCSamples(BaseSamples):
    """Chain-shaped samples ``(n_steps, n_walkers, d)`` stored flattened.

    Parity: reference samples.py:599-806.
    """

    chain_shape: tuple | None = None
    burn_in: int = 0
    thin: int = 1
    autocorrelation_time: Array | None = None

    def __post_init__(self):
        super().__post_init__()
        if self.chain_shape is not None:
            self.chain_shape = tuple(int(s) for s in self.chain_shape)

    @classmethod
    def from_chain(
        cls,
        chain: Array,
        parameters: list[str] | None = None,
        dtype: Any = None,
        **kwargs,
    ) -> "MCMCSamples":
        """Build from a chain array ``(n_steps, n_walkers, d)``."""
        chain = asarray(chain, dtype=dtype)
        if chain.ndim == 2:
            chain = chain[:, None, :]
        chain_shape = chain.shape[:-1]
        x = chain.reshape(-1, chain.shape[-1])
        return cls(
            x=x,
            chain_shape=chain_shape,
            parameters=parameters,
            dtype=dtype,
            **kwargs,
        )

    def __getitem__(self, idx):
        """Slice the flattened samples, keeping chain metadata usable.

        The result's chain degenerates to one walker of the sliced
        length (reference MCMCSamples.__getitem__ semantics); burn-in /
        thinning provenance and any computed autocorrelation time ride
        along.
        """
        sliced = super().__getitem__(idx)
        sliced.chain_shape = (len(sliced.x), 1)
        sliced.burn_in = self.burn_in
        sliced.thin = self.thin
        sliced.autocorrelation_time = self.autocorrelation_time
        return sliced

    @property
    def chain(self) -> Array:
        """Samples reshaped back to ``(n_steps, n_walkers, d)``."""
        if self.chain_shape is None:
            raise ValueError("chain_shape is not set")
        return self.x.reshape(*self.chain_shape, self.dims)

    def _reshape_like_chain(self, value: Array) -> Array:
        if self.chain_shape is None:
            raise ValueError("chain_shape is not set")
        return value.reshape(*self.chain_shape)

    def compute_autocorrelation_time(self, c: float = 5.0) -> Array:
        """Integrated autocorrelation time per parameter (emcee-style).

        Uses the FFT autocorrelation with Sokal's adaptive window; the
        reference delegates this to ``emcee.autocorr``
        (samples.py:726-806); here it is implemented natively.
        """
        chain = to_numpy(self.chain)  # (n_steps, n_walkers, d)
        n = chain.shape[0]
        taus = []
        for k in range(chain.shape[-1]):
            x = chain[:, :, k]
            x = x - x.mean(axis=0, keepdims=True)
            nfft = 1 << (2 * n - 1).bit_length()
            f = np.fft.fft(x, n=nfft, axis=0)
            acf = np.fft.ifft(f * np.conjugate(f), axis=0)[:n].real
            acf = acf.mean(axis=1)
            if acf[0] <= 0:
                taus.append(np.nan)
                continue
            acf /= acf[0]
            cumulative = 2.0 * np.cumsum(acf) - 1.0
            window = np.arange(n) < c * cumulative
            if window.all():
                tau = cumulative[-1]
            else:
                tau = cumulative[np.argmin(window)]
            taus.append(tau)
        self.autocorrelation_time = jnp.asarray(np.array(taus))
        return self.autocorrelation_time

    def post_process(
        self, burn_in: int | None = None, thin: int | None = None
    ) -> "MCMCSamples":
        """Apply burn-in/thinning along the step axis (reference :726).

        The ``burn_in``/``thin`` attributes on the object record what
        has ALREADY been applied; they are not re-applied here, so a
        no-argument call on a processed chain is a no-op rather than a
        silent double trim.
        """
        if self.chain_shape is None:
            raise ValueError("chain_shape is not set")
        burn_in = 0 if burn_in is None else burn_in
        thin = 1 if thin is None else thin
        chain = self.chain[burn_in::thin]

        def slice_chain(value):
            if value is None:
                return None
            reshaped = self._reshape_like_chain(value)
            return reshaped[burn_in::thin].reshape(-1)

        new_shape = chain.shape[:-1]
        return self.__class__(
            x=chain.reshape(-1, self.dims),
            log_likelihood=slice_chain(self.log_likelihood),
            log_prior=slice_chain(self.log_prior),
            log_q=slice_chain(self.log_q),
            parameters=self.parameters,
            dtype=self.dtype,
            chain_shape=new_shape,
            burn_in=burn_in,
            thin=thin,
        )

    def to_samples(self) -> Samples:
        return Samples.from_samples(self)


@dataclass
class PTMCMCSamples(MCMCSamples):
    """Parallel-tempered chains ``(n_temps, n_steps, n_walkers, d)``.

    Parity: reference samples.py:810-1205, including thermodynamic
    integration (Annis et al. 2019 eqs. 35-37) and stepping-stone
    (eqs. 51-53) evidence estimators.
    """

    betas: Array | None = None
    #: per-rung stretch-move acceptance rate, shape (T,) — dataclass
    #: fields (not ad-hoc attributes) so they ride through
    #: to_dict/save/load with the chain.
    move_acceptance: Array | None = None
    #: per-adjacent-pair DEO swap acceptance rate, shape (T-1,)
    swap_acceptance: Array | None = None

    def __post_init__(self):
        super().__post_init__()
        if self.betas is not None:
            self.betas = to_numpy(self.betas)
            betas = np.atleast_1d(np.asarray(self.betas, dtype=float))
            # Ladder contract (reference samples.py:816-836): a 1-D
            # DECREASING ladder starting at the cold chain beta = 1 —
            # cold_chain()/at_temperature(0) index rung 0 directly, so
            # an ascending ladder would silently hand back the prior.
            if betas.ndim != 1:
                raise ValueError("betas must be one-dimensional")
            if self.chain_shape is not None and len(betas) != int(
                self.chain_shape[0]
            ):
                raise ValueError(
                    f"Got {len(betas)} betas for "
                    f"{self.chain_shape[0]} temperature rungs"
                )
            if len(betas) > 1 and np.any(np.diff(betas) >= 0):
                raise ValueError(
                    "betas must be strictly decreasing (cold chain "
                    "first)"
                )
            if not np.isclose(betas[0], 1.0):
                raise ValueError(
                    f"betas must start at 1 (cold chain); got "
                    f"{betas[0]}"
                )

    def __getitem__(self, idx):
        raise NotImplementedError(
            "Slicing is not supported for PTMCMCSamples. Use "
            "at_temperature() to extract samples at a specific temperature."
        )

    def post_process(
        self, burn_in: int | None = None, thin: int | None = None
    ) -> "PTMCMCSamples":
        """Burn-in/thin along the STEP axis of every temperature rung.

        The inherited implementation would slice axis 0 — the
        temperature axis — and silently drop rungs (and ``betas``).
        """
        if self.chain_shape is None:
            raise ValueError("chain_shape is not set")
        burn_in = 0 if burn_in is None else burn_in
        thin = 1 if thin is None else thin
        chain = self.chain[:, burn_in::thin]

        def slice_chain(value):
            if value is None:
                return None
            reshaped = self._reshape_like_chain(value)
            return reshaped[:, burn_in::thin].reshape(-1)

        return self.__class__(
            x=chain.reshape(-1, self.dims),
            log_likelihood=slice_chain(self.log_likelihood),
            log_prior=slice_chain(self.log_prior),
            log_q=slice_chain(self.log_q),
            parameters=self.parameters,
            dtype=self.dtype,
            chain_shape=chain.shape[:-1],
            burn_in=burn_in,
            thin=thin,
            betas=self.betas,
            # Run-level diagnostics ride along unchanged: they describe
            # the chains that PRODUCED these samples.
            move_acceptance=self.move_acceptance,
            swap_acceptance=self.swap_acceptance,
        )

    def compute_autocorrelation_time(self, c: float = 5.0) -> Array:
        """Per-temperature, per-parameter IAT, shape ``(T, d)``.

        The inherited 3-D implementation would misread the temperature
        axis as the step axis.
        """
        taus = []
        for t in range(self.n_temperatures):
            sub = self.at_temperature(t)
            sub.autocorrelation_time = None
            taus.append(to_numpy(sub.compute_autocorrelation_time(c)))
        self.autocorrelation_time = jnp.asarray(np.stack(taus))
        return self.autocorrelation_time

    @property
    def n_temperatures(self) -> int:
        return self.chain_shape[0]

    def at_temperature(self, index: int) -> MCMCSamples:
        """Samples at temperature ``index`` as plain MCMCSamples."""
        chain = self.chain  # (T, n_steps, n_walkers, d)

        def pick(value):
            if value is None:
                return None
            return self._reshape_like_chain(value)[index].reshape(-1)

        return MCMCSamples(
            x=chain[index].reshape(-1, self.dims),
            log_likelihood=pick(self.log_likelihood),
            log_prior=pick(self.log_prior),
            log_q=pick(self.log_q),
            parameters=self.parameters,
            dtype=self.dtype,
            chain_shape=self.chain_shape[1:],
            burn_in=self.burn_in,
            thin=self.thin,
            autocorrelation_time=(
                self.autocorrelation_time[index]
                if self.autocorrelation_time is not None
                else None
            ),
        )

    def cold_chain(self) -> MCMCSamples:
        return self.at_temperature(0)

    def subsample(
        self, n: int, rng=None, *, key: jax.Array | None = None
    ) -> "PTMCMCSamples":
        """Randomly subsample ``n`` (step, walker) entries per temperature.

        Indices are drawn INDEPENDENTLY per rung: a shared index vector
        would keep the rungs' draws step-aligned (cross-rung
        correlated), violating the independence the TI/stepping-stone
        error reductions assume. Index draws and the gathers run on
        device (vmapped per-rung permutations); ``rng`` only seeds the
        key when no ``key`` is given.
        """
        chain = jnp.asarray(self.chain)
        n_temps = chain.shape[0]
        flat = chain.reshape(n_temps, -1, self.dims)
        total = flat.shape[1]
        if n > total:
            raise ValueError(
                f"Cannot subsample {n} from {total} samples per temperature"
            )
        if key is None:
            rng = rng or np.random.default_rng()
            key = jax.random.key(int(rng.integers(2**63)))
        keys = jax.random.split(key, n_temps)
        idx = jax.vmap(
            lambda k: jax.random.permutation(k, total)[:n]
        )(keys)  # (T, n) without replacement, independent per rung

        def pick(value):
            if value is None:
                return None
            v = jnp.asarray(self._reshape_like_chain(value)).reshape(
                n_temps, -1
            )
            return jnp.take_along_axis(v, idx, axis=1).reshape(-1)

        return self.__class__(
            x=jnp.take_along_axis(
                flat, idx[:, :, None], axis=1
            ).reshape(-1, self.dims),
            log_likelihood=pick(self.log_likelihood),
            log_prior=pick(self.log_prior),
            log_q=pick(self.log_q),
            parameters=self.parameters,
            dtype=self.dtype,
            chain_shape=(n_temps, n, 1),
            burn_in=self.burn_in,
            thin=self.thin,
            betas=self.betas,
            move_acceptance=self.move_acceptance,
            swap_acceptance=self.swap_acceptance,
        )

    def _ladder_logl(
        self, burn_in_fraction: float | None, correlated: bool
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-rung log-likelihood draws, ordered prior -> posterior.

        Returns ``(betas, logl, tau)`` with betas (T,) ascending, logl
        (T, S) after burn-in removal, and tau the per-rung integrated
        autocorrelation time of the logL series (all ones when
        ``correlated`` is off).
        """
        if self.betas is None:
            raise ValueError(
                "This ladder has no inverse temperatures (betas=None); "
                "evidence estimation needs them."
            )
        if self.log_likelihood is None:
            raise ValueError(
                "Evidence estimation needs per-sample log-likelihoods."
            )
        # (T, n_steps, n_walkers)
        by_rung = to_numpy(self._reshape_like_chain(self.log_likelihood))
        if burn_in_fraction:
            skip = int(round(by_rung.shape[1] * burn_in_fraction))
            by_rung = by_rung[:, skip:]
        if by_rung[0].size == 0:
            raise ValueError(
                "Burn-in removed every step of the chain; lower "
                "burn_in_fraction or run longer chains."
            )
        ascending = np.argsort(np.asarray(self.betas))
        betas = np.asarray(self.betas, dtype=np.float64)[ascending]
        by_rung = by_rung[ascending]
        if correlated:
            tau = np.array(
                [_integrated_autocorr_1d(rung) for rung in by_rung]
            )
        else:
            tau = np.ones(len(betas))
        return betas, by_rung.reshape(len(betas), -1), tau

    def log_evidence_thermodynamic_integration(
        self,
        burn_in_fraction: float | None = 0.1,
        method: str = "variance",
        correlated: bool = True,
    ) -> tuple[float, float]:
        """Thermodynamic-integration logZ over the temperature ladder.

        ``method="variance"`` reports the delta-method quadrature error
        (autocorrelation-deflated ESS per rung when ``correlated``);
        ``method="coarse"`` reports the discretization error
        ``|I_full - I_half|`` from re-integrating on every other rung;
        ``method="total"`` adds the Richardson estimate of the
        remaining trapezoid bias, ``|I_full - I_half| / 3``, on top of
        the sampling error — an under-resolved ladder (too few rungs
        where ``E_beta[logL]`` curves) then widens the reported bar
        instead of standing confidently wrong.

        Behavioral parity with reference samples.py:1013-1102; the
        estimator itself is an original jitted reduction
        (:func:`_ti_reduce`).
        """
        betas, logl, tau = self._ladder_logl(burn_in_fraction, correlated)
        # f64 rung means on host; f32-safe centered spread under jit.
        rung_means = logl.mean(axis=1)
        logz = float(np.trapezoid(rung_means, betas))
        err = float(
            _ti_spread_error(betas, logl - rung_means[:, None], tau)
        )
        if method == "variance":
            return logz, err
        # Richardson-style check: keep every other rung plus both
        # endpoints, re-integrate, and compare.
        keep = sorted(set(range(0, len(betas), 2)) | {len(betas) - 1})
        coarse = float(np.trapezoid(rung_means[keep], betas[keep]))
        if method == "coarse":
            return logz, abs(logz - coarse)
        if method == "total":
            # Trapezoid error is O(h^2): halving the grid scales it by
            # ~4, so the residual bias of the full grid is
            # ~|I_full - I_half| / 3. Bias and noise are added
            # linearly (conservative — they do not cancel).
            return logz, err + abs(logz - coarse) / 3.0
        raise ValueError(
            f"Unknown TI error method {method!r}; expected 'variance', "
            "'coarse' or 'total'."
        )

    def log_evidence_stepping_stone(
        self,
        burn_in_fraction: float | None = 0.1,
        correlated: bool = True,
    ) -> tuple[float, float]:
        """Stepping-stone logZ: product of per-rung power ratios.

        Requires the ladder to reach the prior (a rung at beta=0), since
        the telescoping product starts from Z(0)=1.

        Behavioral parity with reference samples.py:1104-1170; the
        estimator is an original all-rungs-at-once jitted reduction
        (:func:`_stepping_stone_reduce`).
        """
        betas, logl, tau = self._ladder_logl(burn_in_fraction, correlated)
        if betas[0] != 0.0:
            raise ValueError(
                "The stepping-stone estimator needs a rung at beta=0 "
                f"(the prior); the hottest rung supplied is at "
                f"beta={betas[0]}."
            )
        # Center each rung on its MAX, not its mean: centered values
        # are then <= 0, so every device-side exponent dbeta * centered
        # is bounded above by 0 — no f32 overflow and no catastrophic
        # base-vs-shift cancellation even when a prior rung's logL
        # spans 1e19 (deep-funnel geometry). The estimator is
        # shift-invariant, so typical problems are bit-unchanged in
        # f64 and statistically unchanged in f32.
        rung_ref = logl.max(axis=1)
        # An all-(-inf) rung (no walker inside the likelihood support)
        # would turn the centering into NaNs; referencing it at 0 keeps
        # the centered values at -inf so the rung honestly contributes
        # a zero power ratio (logZ -> -inf) instead of NaN.
        rung_ref = np.where(np.isfinite(rung_ref), rung_ref, 0.0)
        shifted, err = _stepping_stone_reduce(
            betas, logl - rung_ref[:, None], tau
        )
        # Exact f64 base: sum_j dbeta_j * ref_j over the hotter rungs.
        base = float(np.sum(np.diff(betas) * rung_ref[:-1]))
        return base + float(shifted), float(err)

    def plot_chain(
        self, beta_index: int, n_walkers: int | None = None, **kwargs
    ):
        import matplotlib.pyplot as plt

        chain = to_numpy(self.chain)[beta_index]  # (n_steps, n_walkers, d)
        if n_walkers is not None:
            chain = chain[:, :n_walkers]
        d = chain.shape[-1]
        fig, axes = plt.subplots(d, 1, sharex=True, figsize=(8, 2 * d))
        if d == 1:
            axes = [axes]
        for k, ax in enumerate(axes):
            ax.plot(chain[:, :, k], alpha=0.5, **kwargs)
            ax.set_ylabel(self.parameters[k])
        axes[-1].set_xlabel("step")
        return fig

    def plot_ladder(self, swap_floor: float = 0.15):
        """Ladder-quality diagnostics: rung placement and acceptance.

        Top panel: per-adjacent-pair DEO swap acceptance at the pair
        midpoint (the tempering-gap diagnostic — pairs under
        ``swap_floor`` are flagged). Bottom panel: per-rung stretch-move
        acceptance. Rung positions are drawn as ticks on both.
        Requires the acceptance diagnostics the sampler records
        (``move_acceptance``/``swap_acceptance``).
        """
        import matplotlib.pyplot as plt

        if (
            self.betas is None
            or self.swap_acceptance is None
            or self.move_acceptance is None
        ):
            raise ValueError(
                "plot_ladder needs betas and the recorded acceptance "
                "diagnostics (run the PT sampler to get them)."
            )
        betas = np.asarray(self.betas, dtype=float)
        swap = np.asarray(self.swap_acceptance, dtype=float)
        move = np.asarray(self.move_acceptance, dtype=float)
        mids = 0.5 * (betas[:-1] + betas[1:])
        fig, (ax_swap, ax_move) = plt.subplots(
            2, 1, sharex=True, figsize=(8, 5)
        )
        low = swap < swap_floor
        ax_swap.plot(mids, swap, "o-", color="C0")
        if low.any():
            ax_swap.plot(
                mids[low], swap[low], "o", color="C3",
                label=f"below floor ({swap_floor})",
            )
            ax_swap.legend()
        ax_swap.axhline(swap_floor, color="C3", ls="--", lw=0.8)
        ax_swap.set_ylabel("swap acceptance")
        ax_swap.set_ylim(0, 1.05)
        ax_move.plot(betas, move, "s-", color="C1")
        ax_move.set_ylabel("move acceptance")
        ax_move.set_ylim(0, 1.05)
        ax_move.set_xlabel(r"inverse temperature $\beta$")
        for ax in (ax_swap, ax_move):
            for b in betas:
                ax.axvline(b, color="0.85", lw=0.5, zorder=0)
        fig.tight_layout()
        return fig


@dataclass
class SMCSamples(BaseSamples):
    """Particles at inverse temperature ``beta`` on the tempered path
    ``log p_t = (1-beta) log_q + beta (logL + logPi)``.

    Parity: reference samples.py:1209-1333, with resampling moved fully
    on-device (the reference routes through host numpy ``rng.choice``,
    samples.py:1277-1278).
    """

    beta: float | None = None
    log_evidence: float | None = None
    log_evidence_error: float | None = None

    def log_p_t(self, beta) -> Array:
        log_p_target = self.log_likelihood + self.log_prior
        return (1 - beta) * self.log_q + beta * log_p_target

    def unnormalized_log_weights(self, beta) -> Array:
        # Delegates to the single source of truth for the tempered-path
        # increment (shared with the jitted resample and the ladder);
        # its NaN guard maps invalid densities to -inf.
        return incremental_log_weights(
            self.log_q,
            self.log_likelihood,
            self.log_prior,
            self.beta,
            beta,
        )

    def log_evidence_ratio(self, beta) -> Array:
        log_w = self.unnormalized_log_weights(beta)
        return logsumexp(log_w) - math.log(len(self.x))

    def log_evidence_ratio_variance(self, beta) -> Array:
        """Delta-method variance of the per-step evidence ratio."""
        log_w = self.unnormalized_log_weights(beta)
        m = jnp.max(log_w)
        u = jnp.exp(jnp.minimum(log_w - m, 0.0))
        mean_w = jnp.mean(u)
        var_w = jnp.var(u)
        return jnp.where(
            mean_w != 0, var_w / (len(self) * mean_w**2), jnp.nan
        )

    def log_weights(self, beta) -> Array:
        # unnormalized_log_weights guards NaN -> -inf (the jitted
        # resampling contract); this user-facing accessor keeps the
        # LOUD contract by checking the ingredients instead.
        if bool(
            jnp.isnan(self.log_q).any()
            | jnp.isnan(self.log_likelihood).any()
            | jnp.isnan(self.log_prior).any()
        ):
            raise ValueError(
                f"Log weights contain NaN values for beta={beta}"
            )
        log_w = self.unnormalized_log_weights(beta)
        log_evidence_ratio = logsumexp(log_w) - math.log(len(self.x))
        return log_w + log_evidence_ratio

    # NB: module-level jitted helper, shared across instances — the whole
    # resample (incremental weights -> index construction -> gathers) is
    # ONE device computation. Eagerly chaining these ops costs a host
    # round-trip per op on remote backends (seconds per SMC iteration).
    def resample(
        self,
        beta,
        n_samples: int | None = None,
        key: jax.Array | None = None,
        method: str = "systematic",
        rng=None,
        impl: str = "auto",
    ) -> "SMCSamples":
        """Resample particles to temperature ``beta`` on device.

        ``impl="auto"`` lets GSPMD lower the global gather;
        ``impl="ring"`` uses the hand-rolled shard_map collective
        (:func:`aspire_tpu.ops.resampling.ring_resample_matrix`:
        weight all-gather + ppermute ring) — bit-identical results,
        explicit collective schedule, O(chunk*d) peak memory. Requires
        a mesh-sharded population; ``n_samples`` may differ from ``n``
        (e.g. waste-free ancestor selection) as long as it tiles the
        mesh.
        """
        n = len(self.x)
        if n_samples is None:
            n_samples = n
        if beta == self.beta and n_samples == n:
            logger.warning(
                "Resampling with the same beta value, returning identical "
                "samples"
            )
            return self
        if key is None:
            rng = rng or np.random.default_rng()
            key = jax.random.key(int(rng.integers(2**31 - 1)))
        same_beta = beta == self.beta
        if impl in ("ring", "alltoall"):
            return self._resample_collective(
                key, beta, n_samples, method, impl
            )
        if impl != "auto":
            raise ValueError(
                f"Unknown resampling impl {impl!r}: use 'auto', 'ring' "
                "or 'alltoall'."
            )
        # The NaN guard in incremental_log_weights mirrors the
        # reference's normalized-log-weights guard (samples.py:1244-1249):
        # non-finite weights get zero probability.
        if same_beta:
            log_w = jnp.zeros(n, dtype=self.x.dtype)
        else:
            log_w = incremental_log_weights(
                self.log_q,
                self.log_likelihood,
                self.log_prior,
                self.beta,
                beta,
            )
        in_sharding = getattr(self.x, "sharding", None)
        sharded = (
            isinstance(in_sharding, jax.sharding.NamedSharding)
            and in_sharding.spec
        )
        if sharded:
            # Draw the indices from one replicated weight vector, as the
            # collective resamplers do after their all-gather: reductions
            # split across shards sum in another order, which can move a
            # boundary index and break bit-identity between impls.
            log_w = jax.device_put(
                log_w,
                jax.sharding.NamedSharding(
                    in_sharding.mesh, jax.sharding.PartitionSpec()
                ),
            )
        x, ll, lp, lq = _resample_on_device(
            key,
            log_w,
            self.x,
            self.log_likelihood,
            self.log_prior,
            self.log_q,
            n_samples=int(n_samples),
            method=method,
        )
        # The resampling gather is all-to-all, so GSPMD lowers its
        # output REPLICATED. Left alone, every downstream mutation would
        # then run replicated on all devices (no speedup at all) — pin
        # the outputs back to the input's particle sharding. The
        # device_put is cheap: each device just keeps its own slice.
        if sharded and n_samples % in_sharding.mesh.devices.size == 0:
            # P over the leading axis applies to (n, d) and (n,) alike,
            # and to any output size that tiles the mesh (e.g. the
            # M = n/k ancestor population of waste-free SMC).
            x, ll, lp, lq = jax.device_put((x, ll, lp, lq), in_sharding)
        return self.__class__(
            x=x,
            log_likelihood=ll,
            log_prior=lp,
            log_q=lq,
            beta=beta,
            dtype=self.dtype,
            parameters=self.parameters,
        )

    def _resample_collective(
        self,
        key,
        beta,
        n_samples: int,
        method: str,
        impl: str = "ring",
    ) -> "SMCSamples":
        """Hand-rolled sharded resample with a pinned collective
        schedule: ``impl="ring"`` streams blocks around a ppermute ring
        (O(n * cols) bytes/device, any weight distribution);
        ``impl="alltoall"`` exchanges only the rows that change shards
        in bucketed all_to_all transfers (pod-scale bandwidth, with an
        in-program ring fallback when weights concentrate)."""
        from .ops.resampling import (
            alltoall_resample_matrix,
            ring_resample_matrix,
        )

        matrix_resample = (
            ring_resample_matrix
            if impl == "ring"
            else alltoall_resample_matrix
        )
        sharding = getattr(self.x, "sharding", None)
        if not (
            isinstance(sharding, jax.sharding.NamedSharding)
            and sharding.spec
        ):
            raise ValueError(
                f"impl={impl!r} needs a mesh-sharded population; use "
                "impl='auto' for single-device runs."
            )
        if n_samples % sharding.mesh.devices.size:
            raise ValueError(
                f"impl={impl!r} emits n_samples/S rows per shard: "
                f"n_samples ({n_samples}) must be divisible by the "
                f"mesh size ({sharding.mesh.devices.size})."
            )
        # beta == self.beta with n_samples == n early-returns before
        # reaching the collectives, so the increment is always live.
        log_w = incremental_log_weights(
            self.log_q,
            self.log_likelihood,
            self.log_prior,
            self.beta,
            beta,
        )
        # One ring pass per distinct dtype: fields keep their own
        # precision (live populations can carry f32 positions with
        # f64 densities), preserving bit-identity with impl="auto".
        fields = {
            "x": self.x,
            "log_likelihood": self.log_likelihood[:, None],
            "log_prior": self.log_prior[:, None],
            "log_q": self.log_q[:, None],
        }
        groups: dict = {}
        for name, arr in fields.items():
            groups.setdefault(arr.dtype, []).append(name)
        resampled = {}
        for dt, names in groups.items():
            packed = jnp.concatenate([fields[n] for n in names], axis=1)
            out = matrix_resample(
                key,
                log_w,
                packed,
                sharding.mesh,
                axis_name=sharding.spec[0],
                method=method,
                n_out=int(n_samples),
            )
            col = 0
            for n in names:
                width = fields[n].shape[1]
                resampled[n] = out[:, col : col + width]
                col += width
        return self.__class__(
            x=resampled["x"],
            log_likelihood=resampled["log_likelihood"][:, 0],
            log_prior=resampled["log_prior"][:, 0],
            log_q=resampled["log_q"][:, 0],
            beta=beta,
            dtype=self.dtype,
            parameters=self.parameters,
        )

    def to_standard_samples(self) -> Samples:
        return Samples(
            x=self.x,
            log_likelihood=self.log_likelihood,
            log_prior=self.log_prior,
            parameters=self.parameters,
            log_evidence=self.log_evidence,
            log_evidence_error=self.log_evidence_error,
        )

    def __getitem__(self, idx):
        sliced = super().__getitem__(idx)
        sliced.beta = self.beta
        sliced.log_evidence = self.log_evidence
        sliced.log_evidence_error = self.log_evidence_error
        return sliced

    def __str__(self):
        out = super().__str__()
        if self.log_evidence is not None:
            out += f"Log evidence: {float(self.log_evidence):.2f}\n"
        return out
