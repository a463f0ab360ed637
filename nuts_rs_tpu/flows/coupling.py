"""Built-in normalizing flows for transform adaptation.

The reference delegates the flow entirely to user code through FFI hooks
(nuts-rs ``src/transform/external.rs``, ``src/math/math.rs:262-313``; nutpie
supplies a flowjax flow).  Being JAX-native, this framework ships working
flows out of the box:

* :func:`diag_affine_flow` — trainable diagonal affine map q = sigma*z + mu
  (closed-form refit from draw/grad variances).
* :func:`coupling_flow` — RealNVP-style affine coupling stack over a diagonal
  base layer, trained by minimizing the Fisher divergence of the pushforward
  to N(0, I):  loss = E_x |z(x) + grad_z log pi_z(z(x))|^2, computed from the
  stored warmup draws and gradients (no extra logp evaluations).

Both return a :class:`~nuts_rs_tpu.transform.ops.FlowSpec`.

Convention: ``forward(params, z) -> (q, logdet)`` and
``inverse(params, q) -> (z, logdet)`` both return log|det dF/dz| (the FORWARD
Jacobian log-determinant) so the Hamiltonian energy E = KE - (logp + logdet)
equals -log pi_z(z) + KE up to a constant.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import optax

from ..transform.ops import FlowSpec


# ---------------------------------------------------------------------------
# Diagonal affine flow
# ---------------------------------------------------------------------------

def diag_affine_flow() -> FlowSpec:
    """q = exp(log_sigma) * z + mu with closed-form refits."""

    def forward(params, z):
        log_sigma, mu = params["log_sigma"], params["mu"]
        q = jnp.exp(log_sigma) * z + mu
        return q, jnp.sum(log_sigma)

    def inverse(params, q):
        log_sigma, mu = params["log_sigma"], params["mu"]
        z = (q - mu) * jnp.exp(-log_sigma)
        return z, jnp.sum(log_sigma)

    def init(key, dim, q0, g0):
        var = 1.0 / jnp.clip(jnp.abs(g0), 1e-20, 1e20)
        return {"log_sigma": 0.5 * jnp.log(var), "mu": q0 + var * g0}

    def update(key, params, draws, grads, logps, mask):
        m = mask.astype(draws.dtype)[:, None]
        n = jnp.maximum(jnp.sum(m), 1.0)
        dm = jnp.sum(draws * m, axis=0) / n
        gm = jnp.sum(grads * m, axis=0) / n
        dv = jnp.sum(jnp.square(draws - dm) * m, axis=0) / n
        gv = jnp.sum(jnp.square(grads - gm) * m, axis=0) / n
        var = jnp.sqrt(dv / gv)
        ok = jnp.isfinite(var) & (var > 0)
        var = jnp.where(ok, var, jnp.exp(2.0 * params["log_sigma"]))
        enough = jnp.sum(m) >= 3
        log_sigma = jnp.where(enough, 0.5 * jnp.log(var), params["log_sigma"])
        mu = jnp.where(enough, dm + var * gm, params["mu"])
        return {"log_sigma": log_sigma, "mu": mu}

    return FlowSpec(forward=forward, inverse=inverse, init=init, update=update)


# ---------------------------------------------------------------------------
# RealNVP-style coupling flow
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CouplingFlowConfig:
    num_layers: int = 4
    hidden: int = 32
    train_steps: int = 200
    learning_rate: float = 1e-3
    max_scale: float = 4.0   # tanh clamp on log-scales
    max_shift: float = 30.0  # tanh clamp on shifts
    # Per-refit training-set budget: when the (possibly chain-pooled) window
    # holds more valid points, a uniform random subset of this size trains
    # the refit, so refit cost is independent of chain count / window size.
    max_train_points: int = 4096
    # Plateau early stop: training halts once the best loss has not improved
    # by a relative `early_stop_tol` within `early_stop_patience` steps
    # (params warm-start from the previous refit, so later refits typically
    # converge in a fraction of `train_steps`; measured to dominate flow-run
    # wall-clock otherwise).  Set patience <= 0 to always run `train_steps`.
    early_stop_patience: int = 40
    early_stop_tol: float = 1e-3
    # Both clamps make every layer (and its inverse and logdet) globally
    # bounded, so no point in parameter space can produce non-finite
    # energies — a chain can recover from a bad region instead of wedging.


def _mlp_apply(w, x):
    h = jnp.tanh(x @ w["w1"] + w["b1"])
    return h @ w["w2"] + w["b2"]


def _layer_forward(layer, cfg, z):
    """One affine coupling step; even/odd masks alternate per layer."""
    # stop_gradient: the mask is STRUCTURE, not a parameter.  It lives in the
    # params pytree (so it rides along through optimizer state and storage),
    # but letting Adam train it off {0,1} silently breaks invertibility —
    # forward and inverse stop being inverses and the Hamiltonian energy
    # picks up a position-dependent offset (measured: |F(F^-1(q))-q| up to
    # 10 after 200 refit steps, every leapfrog then rejects at ~exp(-1.3)).
    mask = jax.lax.stop_gradient(layer["mask"])  # [d] 1.0 = passthrough
    z_pass = z * mask
    raw = _mlp_apply(layer["net"], z_pass)
    d = z.shape[-1]
    s = cfg.max_scale * jnp.tanh(raw[:d] / cfg.max_scale) * (1.0 - mask)
    t = cfg.max_shift * jnp.tanh(raw[d:] / cfg.max_shift) * (1.0 - mask)
    q = z_pass + (1.0 - mask) * (z * jnp.exp(s) + t)
    return q, jnp.sum(s)


def _layer_inverse(layer, cfg, q):
    mask = jax.lax.stop_gradient(layer["mask"])  # see _layer_forward
    q_pass = q * mask
    raw = _mlp_apply(layer["net"], q_pass)
    d = q.shape[-1]
    s = cfg.max_scale * jnp.tanh(raw[:d] / cfg.max_scale) * (1.0 - mask)
    t = cfg.max_shift * jnp.tanh(raw[d:] / cfg.max_shift) * (1.0 - mask)
    z = q_pass + (1.0 - mask) * ((q - t) * jnp.exp(-s))
    return z, jnp.sum(s)


def coupling_flow(cfg: CouplingFlowConfig = CouplingFlowConfig()) -> FlowSpec:
    """Diagonal base layer + ``cfg.num_layers`` affine coupling layers."""

    def forward(params, z):
        logdet = jnp.zeros((), z.dtype)
        for layer in params["layers"]:
            z, ld = _layer_forward(layer, cfg, z)
            logdet = logdet + ld
        q = jnp.exp(params["log_sigma"]) * z + params["mu"]
        return q, logdet + jnp.sum(params["log_sigma"])

    def inverse(params, q):
        z = (q - params["mu"]) * jnp.exp(-params["log_sigma"])
        logdet = jnp.sum(params["log_sigma"])
        for layer in reversed(params["layers"]):
            z, ld = _layer_inverse(layer, cfg, z)
            logdet = logdet + ld
        return z, logdet

    def init(key, dim, q0, g0):
        dtype = q0.dtype
        layers = []
        for i in range(cfg.num_layers):
            key, k1 = jax.random.split(key)
            mask = (jnp.arange(dim) % 2 == i % 2).astype(dtype)
            # Identity init: zero output layer.
            w = {
                "w1": jax.random.normal(k1, (dim, cfg.hidden), dtype)
                / jnp.sqrt(jnp.asarray(dim, dtype)),
                "b1": jnp.zeros(cfg.hidden, dtype),
                "w2": jnp.zeros((cfg.hidden, 2 * dim), dtype),
                "b2": jnp.zeros(2 * dim, dtype),
            }
            layers.append({"mask": mask, "net": w})
        var = 1.0 / jnp.clip(jnp.abs(g0), 1e-20, 1e20)
        return {
            "layers": layers,
            "log_sigma": 0.5 * jnp.log(var),
            "mu": q0 + var * g0,
        }

    def fisher_loss(params, draws, grads, mask):
        """Mean |z + grad_z log pi_z(z)|^2 over the masked window."""

        def per_sample(q, g):
            z, _ = inverse(params, q)
            # score of the pushforward: grad_z log pi_z(z)
            #   = (dq/dz)^T g + grad_z log|det dF/dz|
            # computed by differentiating the forward map at z:
            (_, _), fvjp = jax.vjp(lambda zz: forward(params, zz), z)
            zg = fvjp((g, jnp.ones((), q.dtype)))[0]
            return jnp.sum(jnp.square(z + zg))

        losses = jax.vmap(per_sample)(draws, grads)
        m = mask.astype(draws.dtype)
        return jnp.sum(losses * m) / jnp.maximum(jnp.sum(m), 1.0)

    def update(key, params, draws, grads, logps, mask):
        n = draws.shape[0]
        if n > cfg.max_train_points:
            # Uniform random subset of the valid points (scores for invalid
            # slots are negative, so top_k prefers valid ones; leftover
            # invalid slots keep mask=False).
            key, ks = jax.random.split(key)
            score = jnp.where(mask, jax.random.uniform(ks, (n,)), -1.0)
            _, idx = jax.lax.top_k(score, cfg.max_train_points)
            draws, grads, mask = draws[idx], grads[idx], mask[idx]

        opt = optax.adam(cfg.learning_rate)
        opt_state = opt.init(params)
        grad_fn = jax.value_and_grad(fisher_loss)

        if cfg.early_stop_patience > 0:
            # Plateau early stop (see CouplingFlowConfig): a while_loop whose
            # condition tracks the best loss seen; params warm-start from the
            # previous refit so later refits converge far inside train_steps.
            def cond(c):
                return (c["i"] < cfg.train_steps) & (
                    c["i"] - c["best_i"] < cfg.early_stop_patience)

            def body(c):
                loss, g = grad_fn(c["params"], draws, grads, mask)
                updates, opt_state = opt.update(g, c["opt"])
                params = optax.apply_updates(c["params"], updates)
                better = loss < c["best"] * (1.0 - cfg.early_stop_tol)
                return dict(
                    params=params, opt=opt_state, i=c["i"] + 1,
                    best=jnp.minimum(loss, c["best"]),
                    best_i=jnp.where(better, c["i"], c["best_i"]),
                )

            fin = jax.lax.while_loop(cond, body, dict(
                params=params, opt=opt_state, i=jnp.int32(0),
                best=jnp.asarray(jnp.inf, draws.dtype),
                best_i=jnp.int32(0)))
            new_params = fin["params"]
        else:
            def step(carry, _):
                params, opt_state = carry
                loss, g = grad_fn(params, draws, grads, mask)
                updates, opt_state = opt.update(g, opt_state)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), loss

            (new_params, _), _losses = jax.lax.scan(
                step, (params, opt_state), None, length=cfg.train_steps)

        # Monotone acceptance: keep the refit only if it is finite, there was
        # data, and it actually lowered the Fisher loss on the window — a
        # diverged Adam run must never replace a working transform (a bad
        # accepted refit can wedge the chain: every subsequent leapfrog
        # diverges and the sampler stops moving).
        old_loss = fisher_loss(params, draws, grads, mask)
        new_loss = fisher_loss(new_params, draws, grads, mask)
        finite = jnp.all(jnp.asarray(
            [jnp.all(jnp.isfinite(x)) for x in jax.tree.leaves(new_params)]))
        enough = jnp.sum(mask) >= 10
        improved = jnp.isfinite(new_loss) & (new_loss < old_loss)
        ok = finite & enough & improved
        return jax.tree.map(lambda new, old: jnp.where(ok, new, old),
                            new_params, params)

    return FlowSpec(forward=forward, inverse=inverse, init=init, update=update)
