"""Drive mid-ladder checkpoint/resume on the accelerator through the public API."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import sys
import numpy as np
from aspire_tpu import Aspire, Samples, configure_logger
from aspire_tpu.models import GaussianMixtureProblem

configure_logger("INFO")
p = GaussianMixtureProblem(dims=4)
path = "/tmp/resume_drive.h5"

if sys.argv[1] == "start":
    rng = np.random.default_rng(42)
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=4, flow_backend="nsf", seed=1)
    asp.fit(Samples(p.draw_initial_samples(rng, 4000)), n_epochs=15)
    post = asp.sample_posterior(
        sampler="smc", n_samples=16384,
        checkpoint_path=path, checkpoint_every=1,
        max_n_steps=2, max_beta_step=0.2,    # stop mid-ladder
        sampler_kwargs=dict(n_steps=10))
    print("PARTIAL: stopped at beta",
          asp.sampler.history.beta[-1] if asp.sampler.history.beta else None)
else:
    asp = Aspire.resume_from_file(
        path, log_likelihood=p.log_likelihood, log_prior=p.log_prior)
    post = asp.sample_posterior(sampler_kwargs=dict(n_steps=10))
    import numpy as _np
    def _c(mu, var):
        d = len(mu)
        return (-0.5*d*_np.log(2*_np.pi*(1+var)) - 0.5*mu@mu/(1+var))
    true = float(_np.logaddexp(_c(p.mu1, p.var1), _c(p.mu2, p.var2)) - _np.log(2.0))
    lz = float(post.log_evidence); err = float(post.log_evidence_error)
    print(f"RESUMED: logZ={lz:.4f} +- {err:.4f} true={true:.4f} "
          f"diff={abs(lz-true):.4f}", "OK" if abs(lz-true) < max(5*err, 0.3) else "FAIL")
