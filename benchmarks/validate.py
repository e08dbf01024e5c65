"""Statistical validation: every sampler against analytic evidences.

Runs each posterior-sampling strategy on four closed-form targets (the
reference's basic-example Gaussian x uniform prior, the two-Gaussian
mixture x normal prior, a 2-d Rosenbrock banana, and Neal's funnel x
wide-normal prior — the latter two with quadrature truths) on whatever
device is available, and checks the log-evidence against the analytic
value within k-sigma. The flow config under test is the SHIPPING
`nsf-tpu` preset — the same config bench.py headlines — and the CNF
(flow-matching) rows cover all four targets. Prints one JSON line per
(sampler, problem) and exits non-zero on any failure — the statistical
counterpart of the reference's examples.yml smoke CI. 12 sampler
configs x 4 targets + 8 CNF rows = 56 rows (one, the mixture
importance+cnf row, is recorded as informational — see the in-line
note; every other row is a hard gate).

Usage: python benchmarks/validate.py [--n 16384] [--k-sigma 5]
       [--prng-impl rbg]   # certify the rbg opt-in across all gates
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

SAMPLERS = [
    ("importance", {}),
    ("smc", {"sampler_kwargs": {"n_steps": 20}}),
    ("smc", {"sampler_kwargs": {"n_steps": 20}, "device_ladder": True,
             "preconditioning": "none"}),
    ("emcee_smc", {"sampler_kwargs": {"n_steps": 20}}),
    ("rwmh_smc", {"sampler_kwargs": {"n_steps": 20}}),
    # Langevin mixes locally: it needs longer chains on multimodal
    # targets for the mode weights to relax (see TODO.md).
    ("mala_smc", {"sampler_kwargs": {"n_steps": 100}}),
    # The known-hard short-chain case: a single run under-covers its
    # own mode-collapse bias; 5 independent replicates report the
    # between-run spread instead (the jackknife tier).
    ("mala_smc", {"sampler_kwargs": {"n_steps": 10}, "n_replicates": 5}),
    # Same configuration with BOTH mitigations: flow-independence
    # moves (global mode teleports inside the local chains) and the
    # replicated bar.
    ("mala_smc", {"sampler_kwargs": {"n_steps": 10, "flow_moves": 5},
                  "n_replicates": 5}),
    # Windowed (Sokal) tau A/B against the default AR(1) surrogate:
    # same run config, tau recorded from stored chains.
    ("smc", {"sampler_kwargs": {"n_steps": 20, "windowed_tau": True}}),
    ("hmc_smc", {"sampler_kwargs": {"n_steps": 5, "n_leapfrog": 10}}),
    ("nuts_smc", {"sampler_kwargs": {"n_steps": 5, "n_leapfrog": 10}}),
    # PT-MCMC evidence path: adaptive CESS ladder + iterated pilot
    # equal-dE refinement. The GATE is the stepping-stone logZ — for
    # diffuse priors the TI integrand E_beta[logL] spans hundreds of
    # nats near beta=0 (a known TI pathology; on the Rosenbrock box
    # its honest "total" bar is +-tens of nats), while stepping-stone
    # telescopes ratios and stays sharp. TI (method="total") is
    # recorded alongside. Walker count is args.n/32 (chains x
    # temperatures x steps is the actual sample budget). NOTE: PT
    # options are top-level sample() kwargs — `sampler_kwargs` is the
    # SMC mutation-kernel channel only.
    # n_steps=800: a measured A/B on the Rosenbrock banana
    # (benchmarks/dev/pt_rosenbrock_ab.py) pinned a +0.044 stepping-
    # stone bias to per-rung chain EQUILIBRATION (800 steps -> +0.013;
    # more rungs/pilots/walkers barely moved it) — the tightened 0.02
    # floor exposed it at production walker counts.
    ("ptmcmc", {
        "n_steps": 800,
        "n_temperatures": 12,
        "betas": "adaptive",
        "swap_every": 5,
        "ladder_pilot_steps": 40,
        "ladder_pilot_iterations": 2,
    }),
]


def _label(sampler: str, kwargs: dict) -> str:
    label = sampler
    if kwargs.get("device_ladder"):
        label += "+device_ladder"
    if (kwargs.get("sampler_kwargs") or {}).get("flow_moves"):
        label += "+flow_moves"
    if kwargs.get("n_replicates"):
        label += f"+jackknife{kwargs['n_replicates']}"
    if (kwargs.get("sampler_kwargs") or {}).get("windowed_tau"):
        label += "+windowed_tau"
    return label


def analytic_log_z(problem) -> float:
    import numpy as np

    name = type(problem).__name__
    if name == "GaussianProblem":
        return float(problem.true_log_evidence)
    if name == "RosenbrockProblem":
        # 2-d quadrature truth (a 6001^2 grid converges to 4 decimals).
        assert problem.dims == 2
        from scipy.special import logsumexp as lse

        g = np.linspace(problem.lower, problem.upper, 6001)
        dx = g[1] - g[0]
        X, Y = np.meshgrid(g, g, indexing="ij")
        ll = -(100.0 * (Y - X**2) ** 2 + (1 - X) ** 2)
        width = problem.upper - problem.lower
        return float(lse(ll) + 2 * np.log(dx) - 2 * np.log(width))
    if name == "FunnelProblem":
        # Gaussian-product integrals close over the rest dims given v,
        # leaving a 1-D quadrature: Z = int dv N(v;0,scale^2)
        # N(v;0,s^2) * (2 pi (e^v + s^2))^{-(d-1)/2} with s the wide
        # prior scale (targets.py FunnelProblem.log_prior).
        from scipy.special import logsumexp as lse

        scale, s = problem.scale, problem.prior_scale
        d = problem.dims - 1
        v = np.linspace(-60.0, 60.0, 400001)
        dv = v[1] - v[0]
        log_int = (
            -0.5 * v**2 / scale**2
            - 0.5 * np.log(2 * np.pi * scale**2)
            - 0.5 * v**2 / s**2
            - 0.5 * np.log(2 * np.pi * s**2)
            - 0.5 * d * np.log(2 * np.pi * (np.exp(v) + s**2))
        )
        return float(lse(log_int) + np.log(dv))
    if name == "GaussianMixtureProblem":
        def comp(mu, var):
            d = len(mu)
            return (
                -0.5 * d * np.log(2 * np.pi * (1 + var))
                - 0.5 * mu @ mu / (1 + var)
            )

        return float(
            np.logaddexp(
                comp(problem.mu1, problem.var1),
                comp(problem.mu2, problem.var2),
            )
            - np.log(2.0)
        )
    raise ValueError(name)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=16384)
    parser.add_argument("--k-sigma", type=float, default=5.0)
    # Round 4: tightened from 0.05 — the funnel's ~+0.05 flow-fit-seed
    # systematic is now covered by refit replicates, not the floor.
    parser.add_argument("--min-tol", type=float, default=0.02)
    parser.add_argument(
        "--funnel-replicates",
        type=int,
        default=3,
        help="flow-refit pipeline replicates for the funnel gates "
        "(the measured dominant systematic there is flow-fit seed "
        "variation, invisible to a single fitted flow)",
    )
    parser.add_argument(
        "--only",
        default=None,
        help="substring filter on the sampler label (targeted re-runs)",
    )
    parser.add_argument(
        "--problems",
        default=None,
        help="substring filter on the problem class name",
    )
    parser.add_argument(
        "--prng-impl",
        default=None,
        help="sampler PRNG implementation (e.g. 'rbg'); exercises the "
        "Aspire(prng_impl=...) API end-to-end across every gate",
    )
    args = parser.parse_args()

    import numpy as np

    from aspire_tpu import Aspire, Samples, configure_logger
    from aspire_tpu.utils import enable_compilation_cache
    from aspire_tpu.models import (
        FunnelProblem,
        GaussianMixtureProblem,
        GaussianProblem,
        RosenbrockProblem,
    )

    configure_logger("WARNING")
    enable_compilation_cache()
    failures = 0

    def run_gate(
        asp, problem, true, sampler, kwargs, label, replicates=0,
        informational=False, eff_floor=None,
    ):
        """One (sampler, problem) gate; returns ok and prints a JSON line.

        ``informational=True`` rows are recorded but never counted as
        failures — used where the statistical tolerance is honestly too
        wide to certify anything (the JSON says so explicitly, so a
        green run never hides behind an un-failable row).
        ``eff_floor`` additionally requires ``post.efficiency`` (ESS/n)
        above the floor: a k-sigma bar built from a heavy-tailed-weight
        error estimate can be arbitrarily wide, so importance rows must
        also prove their weights carry information.
        """
        extra = {}
        n_req = args.n if sampler != "ptmcmc" else max(args.n // 32, 256)
        try:
            if replicates > 1:
                # Flow-refit pipeline replicates: the sampler-level
                # n_replicates (shared flow) is superseded — strip it.
                kw = {
                    k: v for k, v in kwargs.items() if k != "n_replicates"
                }
                post = asp.replicated_evidence(
                    replicates,
                    refit_flow=True,
                    fit_kwargs={"n_epochs": 25, "batch_size": 512},
                    sampler=sampler,
                    n_samples=n_req,
                    store_sample_history=False,
                    **kw,
                )
                lz = float(post.log_evidence)
                err = float(post.log_evidence_error)
            else:
                post = asp.sample_posterior(
                    sampler=sampler,
                    n_samples=n_req,
                    store_sample_history=False,
                    **kwargs,
                )
                if sampler == "ptmcmc":
                    lz, err = post.log_evidence_stepping_stone()
                else:
                    lz = float(post.log_evidence)
                    err = float(post.log_evidence_error)
            if sampler == "ptmcmc":
                ti_lz, ti_err = (
                    post.log_evidence_thermodynamic_integration(
                        method="total"
                    )
                )
                extra["ti_total"] = [round(ti_lz, 4), round(ti_err, 4)]
                extra["n_temperatures"] = len(post.betas)
            tol = max(args.k_sigma * err, args.min_tol)
            ok = abs(lz - true) < tol
            if hasattr(post, "efficiency"):
                eff = float(post.efficiency)
                extra["efficiency"] = round(eff, 5)
                if eff_floor is not None:
                    extra["eff_floor"] = eff_floor
                    ok = ok and eff >= eff_floor
            history = getattr(asp.sampler, "history", None)
            taus = getattr(history, "mcmc_autocorr", None)
            if taus:
                extra["mean_tau"] = round(float(np.mean(taus)), 3)
            reps = getattr(post, "log_evidence_replicates", None)
            if reps is not None:
                extra["replicates"] = [round(v, 3) for v in reps]
                extra["single_run_err"] = round(
                    float(post.log_evidence_error_single), 4
                )
        except Exception as exc:  # noqa: BLE001
            lz, err, ok = float("nan"), float("nan"), False
            print(f"# {label} raised: {exc!r}", file=sys.stderr)
        record = {
            "problem": type(problem).__name__,
            "sampler": label,
            "log_z": round(lz, 4),
            "log_z_err": round(err, 4),
            "true_log_z": round(true, 4),
            "ok": bool(ok),
            **extra,
        }
        if informational:
            record["informational"] = True
        print(json.dumps(record), flush=True)
        return ok or informational

    for problem, init_fn in [
        (
            GaussianProblem(dims=4),
            lambda rng: rng.normal(1.0, 1.2, size=(8192, 4)),
        ),
        (
            GaussianMixtureProblem(dims=4),
            lambda rng: GaussianMixtureProblem(
                dims=4
            ).draw_initial_samples(rng, 8192),
        ),
        # Curved (banana) non-Gaussian target with a quadrature truth:
        # exercises the bounded transforms + flow on a geometry the two
        # Gaussian targets cannot.
        (
            RosenbrockProblem(dims=2),
            lambda rng: RosenbrockProblem(
                dims=2
            ).draw_initial_samples(rng, 8192),
        ),
        # Neal's funnel x wide-normal prior: hierarchical-variance
        # geometry with a 1-D quadrature truth. The prior rung's logL
        # spans ~1e19 — the target that exposed (and now regression-
        # gates) the stepping-stone f32 overflow.
        (
            FunnelProblem(dims=5),
            lambda rng: FunnelProblem(dims=5).draw_initial_samples(
                rng, 8192
            ),
        ),
    ]:
        if args.problems and args.problems not in type(problem).__name__:
            continue
        rng = np.random.default_rng(0)
        asp = Aspire(
            log_likelihood=problem.log_likelihood,
            log_prior=problem.log_prior,
            dims=problem.dims,
            prior_bounds=problem.prior_bounds,
            flow_backend="nsf",
            # The SHIPPING preset (the config bench.py headlines): the
            # gates certify exactly what the benchmark measures
            # (round-5 verdict item — previously only a 2-target refit
            # A/B covered the preset).
            architecture="nsf-tpu",
            seed=1,
            prng_impl=args.prng_impl,
        )
        # The funnel's dominant systematic is flow-fit seed variation
        # (a measured A/B, see TODO.md): every funnel gate runs the
        # flow-refit pipeline-replicate tier so its bar covers it.
        is_funnel = type(problem).__name__ == "FunnelProblem"
        replicates = args.funnel_replicates if is_funnel else 0
        suffix = f"+refit{replicates}" if replicates > 1 else ""

        def eff_label(sampler, kwargs):
            label = _label(sampler, kwargs)
            if replicates > 1:
                # run_gate strips the sampler-level n_replicates (the
                # refit tier supersedes it); the label must not claim a
                # jackknife that never ran. Keep the configs distinct:
                # these rows are the deliberately short-chain ones.
                k = kwargs.get("n_replicates")
                label = label.replace(f"+jackknife{k}", "+shortchain")
                label += suffix
            return label

        todo = [
            (sampler, kwargs, eff_label(sampler, kwargs))
            for sampler, kwargs in SAMPLERS
            if not args.only or args.only in eff_label(sampler, kwargs)
        ]
        if not todo:
            continue
        asp.fit(Samples(init_fn(rng)), n_epochs=25, batch_size=512)
        true = analytic_log_z(problem)
        for sampler, kwargs, label in todo:
            failures += not run_gate(
                asp, problem, true, sampler, kwargs, label,
                replicates=replicates,
            )

    # CNF (flow-matching) gates: the one flow family whose log_prob is
    # an ODE-quadrature approximation (RK4 transport + exact-divergence
    # augmentation, flows/matching.py) gets its own end-to-end accuracy
    # gates, on ALL FOUR targets (round 5 — the curved Rosenbrock and
    # hierarchical funnel geometries are exactly where ODE-quadrature
    # log_prob error would show). Importance weights consume the
    # approximate log_prob directly; SMC additionally stresses it
    # inside the tempering loop, and the SMC row is the tight assertion
    # on every target. Importance+cnf rows carry an efficiency floor so
    # a heavy-tailed-weight error bar can never produce an un-failable
    # gate; on the separated two-mode mixture the CFM transport's IS
    # weights are KNOWN heavy-tailed (measured A/B:
    # benchmarks/dev/cnf_mixture_ab.py — the round-4 reading was
    # -10.45 +- 0.76, a 3.8-nat bar that certifies nothing), so that
    # one row is recorded as informational and the SMC+cnf row carries
    # the mixture assertion.
    for problem, init_fn in [
        (
            GaussianProblem(dims=4),
            lambda rng: rng.normal(1.0, 1.2, size=(8192, 4)),
        ),
        (
            GaussianMixtureProblem(dims=4),
            lambda rng: GaussianMixtureProblem(
                dims=4
            ).draw_initial_samples(rng, 8192),
        ),
        (
            RosenbrockProblem(dims=2),
            lambda rng: RosenbrockProblem(
                dims=2
            ).draw_initial_samples(rng, 8192),
        ),
        (
            FunnelProblem(dims=5),
            lambda rng: FunnelProblem(dims=5).draw_initial_samples(
                rng, 8192
            ),
        ),
    ]:
        if args.problems and args.problems not in type(problem).__name__:
            continue
        is_mixture = type(problem).__name__ == "GaussianMixtureProblem"
        todo = [
            (sampler, kwargs, _label(sampler, kwargs) + "+cnf")
            for sampler, kwargs in [
                ("importance", {}),
                ("smc", {"sampler_kwargs": {"n_steps": 20}}),
            ]
            if not args.only
            or args.only in _label(sampler, kwargs) + "+cnf"
        ]
        if not todo:
            continue
        rng = np.random.default_rng(0)
        asp = Aspire(
            log_likelihood=problem.log_likelihood,
            log_prior=problem.log_prior,
            dims=problem.dims,
            prior_bounds=problem.prior_bounds,
            flow_matching=True,
            n_steps=64,
            seed=1,
            prng_impl=args.prng_impl,
        )
        # CFM velocity-field regression needs a longer schedule than
        # the NSF's 25 epochs to tighten the transport map.
        asp.fit(Samples(init_fn(rng)), n_epochs=120, batch_size=512)
        true = analytic_log_z(problem)
        for sampler, kwargs, label in todo:
            is_importance = sampler == "importance"
            failures += not run_gate(
                asp, problem, true, sampler, kwargs, label,
                informational=is_importance and is_mixture,
                eff_floor=0.01 if is_importance else None,
            )
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
