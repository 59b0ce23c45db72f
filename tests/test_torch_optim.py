"""Port parity for the optimisation tools: ``ad/optimizers.py`` (Adam, SGD
and RMSProp step by step against the JAX package's optax-backed
optimizers, the state reset of ``__setitem__`` included) and
``ad/largesteps.py`` (the Laplacian bit-equal, the differential
coordinates, the block CG solve and its gradient against JAX's
``custom_vjp``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3_tpu.ad import largesteps as ls_j
from mitsuba3_tpu.ad import optimizers as opt_j

import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch.ad import largesteps as ls_t
from mitsuba3_tpu_torch.ad import optimizers as opt_t

torch.set_num_threads(1)

OPTIMIZERS = {
    "adam": lambda pkg, p: pkg.Adam(lr=0.05, params=p),
    "adam_betas": lambda pkg, p: pkg.Adam(lr=0.01, beta_1=0.8, beta_2=0.99,
                                          params=p),
    "sgd": lambda pkg, p: pkg.SGD(lr=0.1, params=p),
    "sgd_momentum": lambda pkg, p: pkg.SGD(lr=0.1, momentum=0.9, params=p),
    "rmsprop": lambda pkg, p: pkg.RMSProp(lr=0.01, params=p),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_optax(np_rng, name):
    """Five steps on a random dict of parameters, with a write after the
    third (which re-initialises every state slot), allclose (rtol 1e-6)
    to the JAX package's optimizer; gradients are random, some near
    zero."""
    shapes = {"albedo": (4, 3), "vertices": (50, 3), "scale": ()}
    params = {k: np_rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (np_rng.normal(size=s) * 10.0 ** np_rng.integers(
        -8, 1, size=s)).astype(np.float32) for k, s in shapes.items()}
        for _ in range(5)]
    oj = OPTIMIZERS[name](opt_j, {k: jnp.asarray(v)
                                  for k, v in params.items()})
    ot = OPTIMIZERS[name](mt.ad, {k: torch.as_tensor(v)
                                  for k, v in params.items()})
    for i, g in enumerate(grads):
        if i == 3:
            reset = np_rng.normal(size=shapes["albedo"]).astype(np.float32)
            oj["albedo"] = jnp.asarray(reset)
            ot["albedo"] = torch.as_tensor(reset)
        oj.step({k: jnp.asarray(v) for k, v in g.items()})
        ot.step({k: torch.as_tensor(v) for k, v in g.items()})
        for k in shapes:
            np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k}, step {i}")
    assert sorted(k for k, _ in ot.items()) == sorted(shapes)


def test_rmsprop_is_optax_not_torch(np_rng):
    """RMSProp decays by 0.9 and adds eps inside the square root (optax),
    which is not torch.optim.RMSprop's default rule."""
    p = torch.as_tensor(np_rng.normal(size=8).astype(np.float32))
    g = torch.full((8,), 1e-4)
    ot = mt.ad.RMSProp(lr=0.01, params={"x": p})
    ot.step({"x": g})
    want = p - 0.01 * g * torch.rsqrt(0.1 * g ** 2 + 1e-8)
    torch.testing.assert_close(ot["x"], want, rtol=1e-6, atol=0)
    ref = p.clone().requires_grad_(True)
    torch_rms = torch.optim.RMSprop([ref], lr=0.01)
    ref.grad = g.clone()
    torch_rms.step()
    assert not torch.allclose(ot["x"], ref.detach(), rtol=1e-6, atol=0)


def test_optimizer_step_keeps_no_graph():
    leaf = torch.ones(3, requires_grad=True)
    ot = mt.ad.Adam(lr=0.1, params={"x": leaf * 2})
    ot.step({"x": torch.ones(3)})
    assert not ot["x"].requires_grad and ot["x"].grad_fn is None


# ---------------------------------------------------------------------------
# LargeSteps
# ---------------------------------------------------------------------------

def grid_mesh(np_rng, side=12):
    """A side x side heightfield (welded vertices) with random heights."""
    xs = np.linspace(-1, 1, side, dtype=np.float32)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    Z = 0.2 * np_rng.normal(size=X.shape).astype(np.float32)
    verts = np.stack([X, Y, Z], -1).reshape(-1, 3)
    idx = np.arange(side * side).reshape(side, side)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[:-1, 1:].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, c], -1),
                            np.stack([b, d, c], -1)], 0).astype(np.int32)
    return verts, faces


@pytest.mark.parametrize("method", ["uniform", "cotan"])
def test_mesh_laplacian_bit_equal(np_rng, method):
    verts, faces = grid_mesh(np_rng)
    for a, b in zip(ls_t.mesh_laplacian(verts, faces, method),
                    ls_j.mesh_laplacian(verts, faces, method)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["uniform", "cotan"])
def test_largesteps_matches_jax(np_rng, method):
    """to_differential, from_differential (one block CG) and the gradient
    of a weighted sum through from_differential (the same solve on the
    cotangent) allclose to JAX's; the round trip gives the vertices
    back."""
    verts, faces = grid_mesh(np_rng)
    lj = ls_j.LargeSteps(verts, faces, lambda_=19.0, method=method)
    lt = mt.ad.LargeSteps(verts, faces, lambda_=19.0, method=method,
                          device="cpu")
    u_j = np.asarray(lj.to_differential(verts))
    u_t = lt.to_differential(verts)
    np.testing.assert_allclose(u_t.numpy(), u_j, rtol=1e-6, atol=1e-6)
    v_t = lt.from_differential(u_t)
    np.testing.assert_allclose(v_t.numpy(), verts, rtol=0, atol=1e-4)
    assert 1 <= lt.cg_iterations < lt.cg_iters

    w = np_rng.normal(size=verts.shape).astype(np.float32)
    u = (u_j + 0.1 * np_rng.normal(size=u_j.shape)).astype(np.float32)
    np.testing.assert_allclose(
        lt.from_differential(u).numpy(),
        np.asarray(lj.from_differential(jnp.asarray(u))), rtol=0,
        atol=1e-5)
    g_j = np.asarray(jax.grad(lambda x: jnp.sum(
        lj.from_differential(x) * w))(jnp.asarray(u)))
    u_leaf = torch.as_tensor(u).requires_grad_(True)
    (lt.from_differential(u_leaf) * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(u_leaf.grad.numpy(), g_j, rtol=0,
                               atol=1e-5 * np.abs(g_j).max())


def test_cg_result_independent_of_check_interval(np_rng, monkeypatch):
    """The solve reads its convergence test every CHECK_EVERY iterations
    and freezes converged state in between, so it returns what a check
    every iteration returns, bit for bit."""
    verts, faces = grid_mesh(np_rng)
    lt = mt.ad.LargeSteps(verts, faces, lambda_=19.0, device="cpu")
    b = torch.as_tensor(np_rng.normal(size=verts.shape).astype(np.float32))
    results = {}
    for every in (1, 3, 8):
        monkeypatch.setattr(ls_t, "CHECK_EVERY", every)
        results[every] = (lt.solve(b), lt.cg_iterations)
    for every in (3, 8):
        assert torch.equal(results[every][0], results[1][0])
        assert results[every][1] == results[1][1]


def test_largesteps_takes_the_device_of_its_vertices(np_rng, monkeypatch):
    verts, faces = grid_mesh(np_rng, side=4)
    lt = mt.ad.LargeSteps(torch.as_tensor(verts), torch.as_tensor(faces))
    assert lt.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.ad.LargeSteps(verts, faces)
