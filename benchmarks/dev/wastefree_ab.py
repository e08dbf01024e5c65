"""A/B: standard vs waste-free SMC at 131072 particles on the accelerator."""
import os, sys, time
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
import numpy as np
from aspire_tpu import Aspire, Samples, configure_logger
from aspire_tpu.models import GaussianMixtureProblem

configure_logger("WARNING")
p = GaussianMixtureProblem(dims=4)
rng = np.random.default_rng(42)
asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
             dims=4, flow_backend="nsf", seed=1)
asp.fit(Samples(p.draw_initial_samples(rng, 8192)), n_epochs=20, batch_size=512)

n = 131072
true = -9.3709
# n_steps must divide n for waste-free pooling (16 | 131072).
for label, kw in [("standard  ", {"n_steps": 16}),
                  ("waste-free", {"n_steps": 16, "waste_free": True})]:
    common = dict(sampler="smc", n_samples=n, preconditioning="none",
                  store_sample_history=False, sampler_kwargs=kw)
    asp.sample_posterior(**common)  # warm
    ts = []
    for _ in range(3):
        t0 = time.time()
        post = asp.sample_posterior(**common)
        ts.append(time.time() - t0)
    ts.sort()
    print(f"{label}: median {ts[1]:5.2f}s  logZ {float(post.log_evidence):.4f}"
          f"+-{float(post.log_evidence_error):.4f} (true {true})  "
          f"evals={asp.sampler.n_likelihood_evaluations}", flush=True)
