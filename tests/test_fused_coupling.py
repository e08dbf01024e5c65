"""Coupling and MAF density passes: the XLA path against a float64 numpy
reference, and the fused GPU kernel (interpret mode) against the XLA
path.

The compiled kernel runs only on a GPU; here it runs through the Pallas
interpreter, and the dispatch predicate, the operand layout and the
gradient rule are checked on CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aspire_tpu.flows.architectures import MAF, Coupling
from aspire_tpu.flows.nets import made_masks
from aspire_tpu.ops import fused_coupling as FC

MIN_W = MIN_H = MIN_D = 1e-3


# ---------------------------------------------------------------------------
# float64 numpy reference of the transforms
# ---------------------------------------------------------------------------


def _np_softmax(r):
    e = np.exp(r - r.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _np_rqs(v, raw, K, tb, inverse):
    """Monotone rational-quadratic spline with identity tails, float64."""
    w = MIN_W + (1 - MIN_W * K) * _np_softmax(raw[..., :K])
    h = MIN_H + (1 - MIN_H * K) * _np_softmax(raw[..., K:2 * K])
    deriv = MIN_D + np.logaddexp(raw[..., 2 * K:], 0.0)
    ones = np.ones(v.shape + (1,))
    xk = np.concatenate([-tb * ones, np.cumsum(w, -1) * 2 * tb - tb], -1)
    yk = np.concatenate([-tb * ones, np.cumsum(h, -1) * 2 * tb - tb], -1)
    dk = np.concatenate([ones, deriv, ones], -1)
    inside = (v > -tb) & (v < tb)
    safe = np.clip(v, -tb, tb)
    knots = yk if inverse else xk
    k = np.clip((safe[..., None] >= knots[..., :-1]).sum(-1) - 1, 0, K - 1)

    def at(a, off):
        return np.take_along_axis(a, (k + off)[..., None], -1)[..., 0]

    x0, x1, y0, y1 = at(xk, 0), at(xk, 1), at(yk, 0), at(yk, 1)
    d0, d1 = at(dk, 0), at(dk, 1)
    width, height = x1 - x0, y1 - y0
    s = height / width
    if inverse:
        yr = safe - y0
        a = height * (s - d0) + yr * (d1 + d0 - 2 * s)
        b = height * d0 - yr * (d1 + d0 - 2 * s)
        c = -s * yr
        xi = np.clip(2 * c / (-b - np.sqrt(np.maximum(b * b - 4 * a * c, 0))),
                     0, 1)
        out = x0 + xi * width
    else:
        xi = np.clip((safe - x0) / width, 0, 1)
        out = y0 + height * (s * xi**2 + d0 * xi * (1 - xi)) / (
            s + (d1 + d0 - 2 * s) * xi * (1 - xi)
        )
    den = s + (d1 + d0 - 2 * s) * xi * (1 - xi)
    ld = (
        2 * np.log(s)
        + np.log(d1 * xi**2 + 2 * s * xi * (1 - xi) + d0 * (1 - xi) ** 2)
        - 2 * np.log(den)
    )
    ld = -ld if inverse else ld
    return np.where(inside, out, v), np.where(inside, ld, 0.0)


def _np_transform(arch, h, v, inverse):
    if arch.transformer == "affine":
        shift, log_scale = h[..., 0], 3.0 * np.tanh(h[..., 1] / 3.0)
        if inverse:
            return (v - shift) * np.exp(-log_scale), -log_scale
        return v * np.exp(log_scale) + shift, log_scale
    return _np_rqs(v, h, arch.num_bins, arch.tail_bound, inverse)


def _np_mlp(layers, x, masks=None):
    h = x
    for j, lyr in enumerate(layers):
        w = np.asarray(lyr["w"], np.float64)
        if masks is not None:
            w = w * masks[j]
        h = h @ w + np.asarray(lyr["b"], np.float64)
        if j < len(layers) - 1:
            h = np.maximum(h, 0.0)
    return h


def np_coupling(arch, params, x, mode):
    """``Coupling._forward_xla`` ("forward") or ``_inverse_xla``."""
    d, n = arch.dims, x.shape[0]
    layers = list(enumerate(params["layers"]))
    if mode == "inverse":
        layers = layers[::-1]
    z, total = np.asarray(x, np.float64), np.zeros(n)
    for i, mlp in layers:
        cond = ((np.arange(d) % 2) + i) % 2 == 1
        h = _np_mlp(mlp["layers"], np.where(cond, z, 0.0)).reshape(n, d, -1)
        y, ld = _np_transform(arch, h, z, inverse=mode == "forward")
        z = np.where(cond, z, y)
        total += np.where(cond, 0.0, ld).sum(-1)
    return z, total


def np_maf_forward(arch, params, x):
    d, n = arch.dims, x.shape[0]
    masks, _ = made_masks(d, list(arch.n_hidden), arch._n_params_per_dim)
    z, total = np.asarray(x, np.float64), np.zeros(n)
    for mlp in params["layers"]:
        h = _np_mlp(mlp["layers"], z, masks).reshape(n, d, -1)
        z, ld = _np_transform(arch, h, z, inverse=True)
        total += ld.sum(-1)
        z = z[:, ::-1]
    return z, total


def _perturb(params, scale=0.1, seed=1):
    return jax.tree.map(
        lambda p: (
            p + scale * jax.random.normal(jax.random.key(seed), p.shape)
        ).astype(jnp.float32),
        params,
    )


def _assert_close(got, want, rel):
    """Relative-to-magnitude agreement: |got - want| <= rel (1 + |want|).

    ``rel`` is set from float32's resolution (~1.2e-7) times the growth
    of rounding error through a few layers of 64-wide sums.
    """
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    err = np.max(np.abs(got - want) / (1 + np.abs(want)))
    assert err <= rel, f"max relative error {err} > {rel}"


@pytest.fixture(params=["affine", "rqs"])
def arch(request):
    return Coupling(
        dims=4, n_layers=3, n_hidden=(32, 32), transformer=request.param
    )


@pytest.fixture
def params(arch, key):
    return _perturb(arch.init(key))


# ---------------------------------------------------------------------------
# XLA path vs the float64 reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["forward", "inverse"])
@pytest.mark.parametrize("n", [64, 1000, 2500])
def test_xla_matches_float64_reference(arch, params, mode, n):
    x = jax.random.normal(jax.random.key(2), (n, arch.dims), jnp.float32)
    fn = arch._forward_xla if mode == "forward" else arch._inverse_xla
    y, ld = fn(params, x)
    y_ref, ld_ref = np_coupling(arch, params, np.asarray(x), mode)
    _assert_close(y, y_ref, 1e-4)
    _assert_close(ld, ld_ref, 1e-4)


def test_round_trip(arch, params):
    x = jax.random.normal(jax.random.key(3), (256, arch.dims), jnp.float32)
    z, ld_f = arch.forward(params, x)
    x_back, ld_i = arch.inverse(params, z)
    np.testing.assert_allclose(x_back, x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ld_f, -ld_i, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["forward", "inverse"])
def test_extreme_params_and_boundary_inputs(mode):
    """Saturated raw params and inputs at and beyond the spline tails
    stay finite and match the reference (identity outside the tails)."""
    arch = Coupling(dims=4, n_layers=2, n_hidden=(16, 16), transformer="rqs")
    params = _perturb(arch.init(jax.random.key(0)), scale=3.0, seed=9)
    tb = arch.tail_bound
    x = jnp.concatenate(
        [
            jax.random.normal(jax.random.key(10), (64, 4), jnp.float32),
            jnp.full((8, 4), tb, jnp.float32),
            jnp.full((8, 4), -tb, jnp.float32),
            jnp.full((8, 4), 3 * tb, jnp.float32),
            jnp.full((8, 4), -3 * tb, jnp.float32),
            jnp.zeros((8, 4), jnp.float32),
        ]
    )
    fn = arch._forward_xla if mode == "forward" else arch._inverse_xla
    y, ld = fn(params, x)
    y_ref, ld_ref = np_coupling(arch, params, np.asarray(x), mode)
    # Saturated softmaxes leave bins of width ~1e-3: f32 knots carry
    # ~1e-6 absolute error, which the spline's slope amplifies.
    _assert_close(y, y_ref, 5e-3)
    _assert_close(ld, ld_ref, 5e-3)


@pytest.mark.parametrize("mode", ["forward", "inverse"])
def test_gradient_matches_finite_differences(arch, params, mode):
    """d/dx of sum(z^2) + sum(log_det) against central differences in
    float64 (so the difference quotient is not rounding-limited)."""
    p64 = jax.tree.map(lambda p: p.astype(jnp.float64), params)
    x = jax.random.normal(jax.random.key(4), (8, arch.dims), jnp.float64)
    fn = arch._forward_xla if mode == "forward" else arch._inverse_xla

    def loss(x):
        y, ld = fn(p64, x)
        return jnp.sum(y**2) + jnp.sum(ld)

    grad = np.asarray(jax.grad(loss)(x))
    eps = 1e-6
    fd = np.zeros_like(grad)
    for i in range(x.shape[0]):
        for j in range(x.shape[1]):
            e = jnp.zeros_like(x).at[i, j].set(eps)
            fd[i, j] = (loss(x + e) - loss(x - e)) / (2 * eps)
    np.testing.assert_allclose(grad, fd, rtol=1e-5, atol=1e-6)


def test_density_pass_in_jit_and_scan(arch, params):
    """The density pass composes with jit and scan as in the SMC loop."""
    x = jax.random.normal(jax.random.key(5), (64, arch.dims), jnp.float32)

    @jax.jit
    def step(x):
        y, ld = arch.forward(params, x)
        return y * 0.5, ld

    def body(carry, _):
        y, ld = step(carry)
        return y, jnp.sum(ld)

    out, lds = jax.lax.scan(body, x, None, length=3)
    assert out.shape == x.shape
    assert lds.shape == (3,)
    assert np.isfinite(np.asarray(lds)).all()


class TestMAF:
    @pytest.mark.parametrize("transformer", ["affine", "rqs"])
    @pytest.mark.parametrize("n", [64, 1000])
    def test_matches_float64_reference(self, transformer, n):
        arch = MAF(dims=4, n_layers=3, n_hidden=(32, 32),
                   transformer=transformer)
        params = _perturb(arch.init(jax.random.key(5)))
        x = jax.random.normal(jax.random.key(6), (n, 4), jnp.float32)
        z, ld = arch.forward(params, x)
        z_ref, ld_ref = np_maf_forward(arch, params, np.asarray(x))
        _assert_close(z, z_ref, 1e-4)
        _assert_close(ld, ld_ref, 1e-4)

    def test_gradient_matches_finite_differences(self):
        arch = MAF(dims=3, n_layers=2, n_hidden=(16, 16), transformer="rqs")
        p64 = jax.tree.map(
            lambda p: p.astype(jnp.float64),
            _perturb(arch.init(jax.random.key(7))),
        )
        x = jax.random.normal(jax.random.key(8), (4, 3), jnp.float64)

        def loss(x):
            z, ld = arch.forward(p64, x)
            return jnp.sum(z**2) + jnp.sum(ld)

        grad = np.asarray(jax.grad(loss)(x))
        eps = 1e-6
        fd = np.zeros_like(grad)
        for i in range(x.shape[0]):
            for j in range(x.shape[1]):
                e = jnp.zeros_like(x).at[i, j].set(eps)
                fd[i, j] = (loss(x + e) - loss(x - e)) / (2 * eps)
        np.testing.assert_allclose(grad, fd, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The fused GPU kernel, through the Pallas interpreter
# ---------------------------------------------------------------------------


def _interpret_kernel(arch, params, x, block=None):
    cfg = FC.kernel_config(arch)
    if block is not None:
        cfg = FC.KernelConfig(**{**cfg.__dict__, "block": block})
    return FC.coupling_density_pallas(
        cfg, FC.prepare_params(cfg, params), x, interpret=True
    )


@pytest.mark.parametrize("transformer", ["affine", "rqs"])
@pytest.mark.parametrize(
    "dims,n_hidden", [(3, (16,)), (4, (64, 64)), (5, (32, 32)), (32, (32, 32))]
)
def test_kernel_matches_xla(transformer, dims, n_hidden):
    """Odd and even d, d padded to a power of two in each parity half,
    one and two hidden layers, narrow outputs taken by broadcast sums."""
    arch = Coupling(dims=dims, n_layers=3, n_hidden=n_hidden,
                    transformer=transformer)
    params = _perturb(arch.init(jax.random.key(11)))
    x = jax.random.normal(jax.random.key(12), (256, dims), jnp.float32)
    z, ld = _interpret_kernel(arch, params, x)
    z_ref, ld_ref = np_coupling(arch, params, np.asarray(x), "forward")
    _assert_close(z, z_ref, 1e-4)
    _assert_close(ld, ld_ref, 1e-4)


def test_kernel_boundary_inputs():
    arch = Coupling(dims=4, n_layers=2, n_hidden=(16, 16), transformer="rqs")
    params = _perturb(arch.init(jax.random.key(0)), scale=3.0, seed=9)
    tb = arch.tail_bound
    x = jnp.concatenate(
        [
            jax.random.normal(jax.random.key(10), (32, 4), jnp.float32),
            jnp.full((8, 4), tb, jnp.float32),
            jnp.full((8, 4), -tb, jnp.float32),
            jnp.full((8, 4), 3 * tb, jnp.float32),
            jnp.full((8, 4), -3 * tb, jnp.float32),
        ]
    )
    z, ld = _interpret_kernel(arch, params, x, block=16)
    z_ref, ld_ref = np_coupling(arch, params, np.asarray(x), "forward")
    _assert_close(z, z_ref, 5e-3)
    _assert_close(ld, ld_ref, 5e-3)


@pytest.mark.parametrize("transformer", ["affine", "rqs"])
@pytest.mark.parametrize("dims", [4, 5, 32])
def test_prepared_operand_shapes(transformer, dims):
    """Per layer: first dense (A, H), hidden (H, H), then one group per
    transformer parameter of width A * K (RQS) or A (affine), padded to
    Triton's 16-column dot minimum."""
    arch = Coupling(dims=dims, n_layers=2, n_hidden=(32, 32),
                    transformer=transformer)
    cfg = FC.kernel_config(arch)
    ops = FC.prepare_params(cfg, arch.init(jax.random.key(0)))
    A = cfg.half
    assert A == max(1 << ((dims + 1) // 2 - 1).bit_length(), 2)
    width = max(A * (arch.num_bins if transformer == "rqs" else 1), 16)
    n_out = 3 if transformer == "rqs" else 2
    per_layer = [(A, 32), (32,), (32, 32), (32,)]
    per_layer += [(32, width), (width,)] * n_out
    assert [o.shape for o in ops] == per_layer * arch.n_layers


def test_prepared_operands_select_the_right_columns():
    """The derivative group of active dim a holds the raw derivative
    columns of dim 2a + parity, with a zero pad column per dim."""
    arch = Coupling(dims=4, n_layers=2, n_hidden=(16, 16))
    params = _perturb(arch.init(jax.random.key(0)), scale=1.0)
    cfg = FC.kernel_config(arch)
    ops = FC.prepare_params(cfg, params)
    K, P = arch.num_bins, arch._n_params_per_dim
    for layer in range(2):
        w_out = np.asarray(params["layers"][layer]["layers"][-1]["w"])
        w_d = np.asarray(ops[layer * 10 + 8])  # derivative group weights
        for a in range(2):
            dim = 2 * a + layer % 2
            np.testing.assert_array_equal(
                w_d[:, a * K:a * K + K - 1],
                w_out[:, dim * P + 2 * K:dim * P + 3 * K - 1],
            )
            np.testing.assert_array_equal(w_d[:, a * K + K - 1], 0.0)


def test_predicate_never_chooses_the_kernel_on_cpu(arch):
    assert not FC.use_kernel(arch, jnp.zeros((8192, 4), jnp.float32))


class _Gpu:
    platform = "gpu"


@pytest.fixture
def on_gpu(monkeypatch):
    """Make the predicate see one GPU so its shape rules can be tested."""
    monkeypatch.setattr(FC.jax, "devices", lambda *a: [_Gpu()])


def test_predicate_keeps_multi_device_processes_on_xla(monkeypatch, arch):
    """No partitioning rule: with four GPUs in the process, XLA runs."""
    monkeypatch.setattr(FC.jax, "devices", lambda *a: [_Gpu()] * 4)
    assert not FC.use_kernel(arch, jnp.zeros((8192, 4), jnp.float32))


@pytest.mark.parametrize(
    "shape,dtype,n_hidden,chosen",
    [
        ((8192, 4), jnp.float32, (64, 64), True),
        ((2048, 4), jnp.float32, (64, 64), True),  # any whole blocks
        ((32, 4), jnp.float32, (64, 64), False),  # less than a block
        ((8200, 4), jnp.float32, (64, 64), False),  # not whole blocks
        ((8192, 4), jnp.float64, (64, 64), False),
        ((8192, 4), jnp.float32, (48, 48), False),  # not a power of two
        ((8192, 4), jnp.float32, (8, 8), False),  # below the dot minimum
        ((8192, 3), jnp.float32, (64, 64), True),
        ((8192, 5), jnp.float32, (64, 64), False),  # wider than _MAX_DIMS
    ],
)
def test_predicate_shape_rules(on_gpu, shape, dtype, n_hidden, chosen):
    arch = Coupling(dims=shape[1], n_layers=2, n_hidden=n_hidden)
    assert FC.use_kernel(arch, jnp.zeros(shape, dtype)) is chosen


@pytest.mark.parametrize(
    "kwargs,chosen",
    [
        (dict(dims=2, transformer="affine"), True),
        (dict(n_layers=4, n_hidden=(16, 64), num_bins=16), True),
        (dict(dims=1), False),  # no conditioning half
        (dict(n_hidden=()), False),  # no hidden layer
        (dict(n_hidden=(64, 64, 64)), False),  # deeper than checked
        (dict(n_hidden=(128,)), False),  # wider than checked
        (dict(n_layers=5), False),
        (dict(num_bins=32), False),
        (dict(dtype="float64"), False),
    ],
)
def test_predicate_keeps_to_the_checked_domain(on_gpu, kwargs, chosen):
    """Only flows whose every axis value ran compiled in the parity
    sweep of chip_smoke.py get the kernel."""
    arch = Coupling(**{"dims": 4, "n_layers": 2, **kwargs})
    x = jnp.zeros((8192, arch.dims), jnp.float32)
    assert FC.use_kernel(arch, x) is chosen


@pytest.fixture
def interpreted_kernel(monkeypatch):
    """Route the dispatched kernel through the interpreter and count it."""
    calls = []
    pallas = FC.coupling_density_pallas

    def run(cfg, prepared, x, interpret=False):
        calls.append(x.shape)
        return pallas(cfg, prepared, x, interpret=True)

    monkeypatch.setattr(FC, "coupling_density_pallas", run)
    monkeypatch.setattr(FC, "use_kernel", lambda arch, x: True)
    return calls


def test_sampling_direction_never_uses_the_kernel(
    arch, params, interpreted_kernel
):
    z = jax.random.normal(jax.random.key(5), (4096, arch.dims), jnp.float32)
    arch.inverse(params, z)
    assert interpreted_kernel == []
    arch.forward(params, z)
    assert interpreted_kernel == [(4096, arch.dims)]


def test_kernel_gradient_recomputes_through_xla(
    arch, params, interpreted_kernel
):
    """The custom_vjp's backward pass is the XLA path's: gradients match
    exactly up to the primal's rounding."""
    x = jax.random.normal(jax.random.key(4), (256, arch.dims), jnp.float32)

    def loss(fn, p, x):
        y, ld = fn(p, x)
        return jnp.sum(y**2) + jnp.sum(ld)

    fused = functools.partial(FC.coupling_density, arch)
    np.testing.assert_allclose(
        loss(fused, params, x), loss(arch._forward_xla, params, x),
        rtol=1e-5,
    )
    g_fused = jax.grad(functools.partial(loss, fused), argnums=(0, 1))(
        params, x
    )
    g_ref = jax.grad(
        functools.partial(loss, arch._forward_xla), argnums=(0, 1)
    )(params, x)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5),
        g_fused,
        g_ref,
    )
    assert interpreted_kernel


@pytest.mark.gpu
def test_compiled_kernel_matches_xla(gpu):
    """The compiled kernel over its whole domain and on the anchor's flow,
    as accurate as the XLA path in full float32 (chip_smoke's parity
    phases)."""
    out = gpu(
        "import chip_smoke; print(chip_smoke.kernel_sweep()['ok'] and "
        "chip_smoke.kernel_parity()['ok'])"
    )
    assert out.strip().splitlines()[-1] == "True", out
