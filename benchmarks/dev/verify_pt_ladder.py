"""Accelerator drive of the adaptive PT ladder (betas="adaptive" + pilot).

Fits a flow on the 2-D box-Gaussian (analytic logZ = -2 log 20), then
runs the parallel-tempered sampler three ways — geometric ladder,
probe-adaptive ladder, and two-phase pilot-refined ladder — and checks
the TI / stepping-stone evidences against the analytic value.
"""

import math
import os
import sys
import time

sys.path.insert(
    0, os.path.join(os.path.dirname(__file__), "..", "..")
)

import jax.numpy as jnp
import numpy as np

from aspire_tpu import Aspire, Samples

DIMS = 2
TRUE_LOG_Z = -DIMS * math.log(20)


def log_likelihood(samples):
    return jnp.sum(
        -0.5 * (samples.x - 1.0) ** 2 - 0.5 * jnp.log(2 * jnp.pi),
        axis=-1,
    )


def log_prior(samples):
    x = samples.x
    inside = jnp.all((x >= -10) & (x <= 10), axis=-1)
    return jnp.where(inside, -DIMS * jnp.log(20.0), -jnp.inf)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    rng = np.random.default_rng(7)
    init = Samples(rng.normal(1.2, 1.1, size=(2000, DIMS)))
    asp = Aspire(
        log_likelihood=log_likelihood,
        log_prior=log_prior,
        dims=DIMS,
        parameters=[f"x_{i}" for i in range(DIMS)],
        prior_bounds={f"x_{i}": [-10, 10] for i in range(DIMS)},
        seed=0,
    )
    t0 = time.time()
    asp.fit(init, n_epochs=20, batch_size=256)
    print(f"fit: {time.time() - t0:.1f}s", flush=True)

    configs = {
        "geometric": {},
        "adaptive": {"betas": "adaptive"},
        "pilot": {"betas": "adaptive", "ladder_pilot_steps": 20},
    }
    failures = []
    for name, extra in configs.items():
        t0 = time.time()
        s = asp.sample_posterior(
            n_samples=n,
            sampler="ptmcmc",
            n_steps=100,
            n_temperatures=6,
            **extra,
        )
        ti, ti_err = s.log_evidence_thermodynamic_integration()
        ss, ss_err = s.log_evidence_stepping_stone()
        betas = np.asarray(s.betas)
        print(
            f"{name:9s} rungs={len(betas)} "
            f"TI={ti:+.3f}±{ti_err:.3f} SS={ss:+.3f}±{ss_err:.3f} "
            f"true={TRUE_LOG_Z:+.3f} wall={time.time() - t0:.1f}s",
            flush=True,
        )
        tol = 1.0 if name == "geometric" else 0.7
        if abs(ss - TRUE_LOG_Z) > tol:
            failures.append(f"{name}: SS off by {ss - TRUE_LOG_Z:+.3f}")
        if name == "pilot" and abs(ti - TRUE_LOG_Z) > 0.5:
            failures.append(f"pilot: TI off by {ti - TRUE_LOG_Z:+.3f}")
    if failures:
        print("FAIL: " + "; ".join(failures))
        sys.exit(1)
    print("PT LADDER ANCHOR OK")


if __name__ == "__main__":
    main()
