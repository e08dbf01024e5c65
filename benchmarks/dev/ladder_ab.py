"""A/B: host ladder vs single-dispatch device ladder on the accelerator."""
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
common = dict(sampler="smc", n_samples=n, preconditioning="none",
              store_sample_history=False, sampler_kwargs=dict(n_steps=20))

for mode, extra in [
    ("host", {"device_ladder": False}),
    ("device", {"device_ladder": True}),
    ("default", {}),  # auto-selects the device ladder since round 2
]:
    # warm (compile)
    asp.sample_posterior(**common, **extra)
    ts = []
    for _ in range(3):
        t0 = time.time()
        post = asp.sample_posterior(**common, **extra)
        ts.append(time.time() - t0)
    ts.sort()
    print(f"{mode:6s} ladder: median {ts[1]:6.2f}s  "
          f"logZ {float(post.log_evidence):.4f} "
          f"n_temps={len(asp.sampler.history.beta)}")
