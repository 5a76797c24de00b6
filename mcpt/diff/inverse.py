"""Inverse rendering: recover material albedo + light emission from a target
image by gradient descent on pixel-space MSE (the BASELINE.json config:
"recover cornell-box albedo + light emission via pixel gradients, Adam").

The optimization step (render -> loss -> grad -> Adam update) is one jitted
XLA program; the sharded variant shard_maps the render over the device mesh
and psums the parameter gradients over the mesh — the renderer's analog of
data-parallel training with gradient all-reduce (SURVEY §2.3).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax

from mcpt.diff.grad import (
    SceneParams,
    apply_params,
    extract_params,
    mse_loss,
    mse_loss_dual,
)
from mcpt.scene import Scene


class InverseState(NamedTuple):
    params: SceneParams
    opt_state: optax.OptState
    step: jnp.ndarray


def make_inverse_step(
    scene: Scene,
    target: jnp.ndarray,
    spp: int = 4,
    max_bounces: int = 6,
    learning_rate: float = 2e-2,
    param_mask: Optional[SceneParams] = None,
    radiance_lr: Optional[float] = None,
    extra_grad_fn: Optional[Callable] = None,
):
    """Build (init_state, step_fn). step_fn is jitted end-to-end.

    `param_mask` (0/1 per entry) freezes parameters where 0 — e.g. optimize
    only the albedo of selected materials. `radiance_lr` gives emission its
    own Adam learning rate: Adam's normalized step moves each coordinate
    ~lr per step, and emitted radiance lives on a scale ~40x reflectance
    (cornell light 42.98 vs kd <= 1), so a shared 2e-2 rate cannot cross
    that distance in the BASELINE 500-step budget.
    """
    # the optimizer is built lazily at init() because the multi_transform
    # label tree must MATCH the param structure: a params pytree carrying
    # dverts keeps it (labeled "slow") — round-4 advisor: silently stripping
    # dverts changed the returned structure and lost the vertex field.
    _opt_box = []

    def _make_opt(params: SceneParams):
        if radiance_lr is None:
            return optax.adam(learning_rate)
        labels = SceneParams(
            kd="slow", ks="slow", radiance="fast",
            dverts=None if params.dverts is None else "slow",
        )
        return optax.multi_transform(
            {"slow": optax.adam(learning_rate),
             "fast": optax.adam(radiance_lr)},
            labels,
        )

    def init(params: SceneParams) -> InverseState:
        _opt_box.clear()
        _opt_box.append(_make_opt(params))
        return InverseState(
            params=params, opt_state=_opt_box[0].init(params),
            step=jnp.zeros((), jnp.int32),
        )

    @jax.jit
    def step_fn(state: InverseState, key) -> tuple:
        opt = _opt_box[0]  # init() must run first (it builds the optimizer)
        k = jax.random.fold_in(key, state.step)
        loss, grads = jax.value_and_grad(mse_loss_dual)(
            state.params, scene, target, k, spp, max_bounces
        )
        # gradient hygiene (the training-loop analog of the film's NaN
        # scrub, src/Scene.cpp:15-18): one firefly path with a non-finite
        # backward would otherwise poison Adam's moments PERMANENTLY —
        # observed on the 500-step 256^2 run (params NaN'd near step ~50,
        # loss froze at the render-of-NaN-scrubbed-params value)
        grads = jax.tree_util.tree_map(
            lambda g: jnp.where(jnp.isfinite(g), g, 0.0), grads
        )
        if extra_grad_fn is not None:
            # opt-in additional gradient terms the detached estimator
            # cannot see — e.g. the NEE visibility (silhouette) term for
            # dverts (diff/edge.make_nee_edge_term). Contract: returns a
            # pytree matching `grads` with zeros for untouched fields.
            extra = extra_grad_fn(state.params, k)
            grads = jax.tree_util.tree_map(
                lambda g, e: g + jnp.where(jnp.isfinite(e), e, 0.0),
                grads, extra,
            )
        if param_mask is not None:
            # field-wise (not tree.map): a mask built without dverts (None)
            # freezes the vertex field rather than mismatching pytree
            # structures against grads that carry one
            dv = grads.dverts
            if dv is not None:
                dv = dv * param_mask.dverts if param_mask.dverts is not None else jnp.zeros_like(dv)
            grads = SceneParams(
                kd=grads.kd * param_mask.kd,
                ks=grads.ks * param_mask.ks,
                radiance=grads.radiance * param_mask.radiance,
                dverts=dv,
            )
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        # physical constraints: reflectances in [0,1], emission >= 0
        params = SceneParams(
            kd=jnp.clip(params.kd, 0.0, 1.0),
            ks=jnp.clip(params.ks, 0.0, 1.0),
            radiance=jnp.maximum(params.radiance, 0.0),
            dverts=params.dverts,  # unconstrained (vertex displacement)
        )
        return InverseState(params=params, opt_state=opt_state, step=state.step + 1), loss

    return init, step_fn


def checkpoint_save_inverse(state: InverseState, path: str) -> None:
    """Persist the FULL optimization state: params + Adam moments + step.

    SURVEY §5 requires optimizer-state checkpointing for the 500-step
    inverse config — resuming from params alone would reset Adam's first/
    second moments and change the trajectory.
    """
    import os

    import numpy as np

    leaves, _ = jax.tree_util.tree_flatten(state)
    # atomic (tmp + replace): a kill mid-write never corrupts the previous
    # checkpoint — same contract as render/film.checkpoint_save
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def checkpoint_load_inverse(path: str, template: InverseState) -> InverseState:
    """Rebuild an InverseState from `checkpoint_save_inverse` output.

    `template` (a freshly init()ed state for the same optimizer/params
    shapes) supplies the pytree structure; the checkpoint supplies leaves.
    """
    import numpy as np

    data = np.load(path)
    leaves, treedef = jax.tree_util.tree_flatten(template)
    assert len(data.files) == len(leaves), (
        f"checkpoint has {len(data.files)} leaves, optimizer state needs "
        f"{len(leaves)} — different optimizer or parameter set"
    )
    new_leaves = [jnp.asarray(data[f"leaf_{i}"]) for i in range(len(leaves))]
    return jax.tree_util.tree_unflatten(treedef, new_leaves)


def run_inverse(
    scene: Scene,
    target: jnp.ndarray,
    init_params: SceneParams,
    steps: int = 500,
    spp: int = 4,
    max_bounces: int = 6,
    learning_rate: float = 2e-2,
    seed: int = 0,
    param_mask: Optional[SceneParams] = None,
    progress: Optional[Callable] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: Optional[str] = None,
    radiance_lr: Optional[float] = None,
    extra_grad_fn: Optional[Callable] = None,
):
    """Adam loop. Returns (final_params, loss_history).

    `checkpoint_every > 0` writes the full optimizer state (params + Adam
    moments + step) every N steps; `resume` restarts from such a file.
    `radiance_lr` gives emission its own Adam rate (see make_inverse_step).
    `extra_grad_fn(params, key) -> grads-pytree` adds opt-in gradient
    terms (the edge-aware visibility term: diff/edge.make_nee_edge_term).
    """
    init, step_fn = make_inverse_step(
        scene, target, spp, max_bounces, learning_rate, param_mask,
        radiance_lr=radiance_lr, extra_grad_fn=extra_grad_fn,
    )
    state = init(init_params)
    if resume:
        state = checkpoint_load_inverse(resume, state)
    key = jax.random.PRNGKey(seed)
    losses = []
    start = int(state.step)
    for i in range(start, steps):
        state, loss = step_fn(state, key)
        losses.append(float(loss))
        if progress is not None and (i % 25 == 0 or i == steps - 1):
            progress(i, losses[-1], state.params)
        if checkpoint_every and checkpoint_path and (i + 1) % checkpoint_every == 0:
            checkpoint_save_inverse(state, checkpoint_path)
    return state.params, losses


# ---------------------------------------------------------------------------
# Sharded gradient step (used by __graft_entry__.dryrun_multichip and
# chip_smoke.py --chips 4)
# ---------------------------------------------------------------------------

def sharded_loss_and_grad(scene: Scene, mesh, params: SceneParams, key,
                          max_bounces: int = 3):
    """Loss and parameter gradients of one render over the mesh: film rows
    shard over 'tiles', the scene + params replicate, and the loss (hence
    every parameter gradient) is psum-reduced over the whole mesh — the
    renderer's gradient all-reduce. The loss is the mean squared radiance
    (MSE against black). On a 1x1 mesh this is the single-device gradient
    of the same estimator."""
    from jax.sharding import PartitionSpec as P

    from mcpt.render.integrator import trace_image

    cam = scene.camera
    W, H = cam.width, cam.height
    nt = mesh.shape["tiles"]
    rows = H // nt

    def local_loss(params, key):
        sc = apply_params(scene, params)
        ti = jax.lax.axis_index("tiles")
        row0 = ti.astype(jnp.int32) * rows
        pixel_idx = row0 * W + jnp.arange(rows * W, dtype=jnp.int32)
        rad = trace_image(sc, sc.camera, key, pixel_idx,
                          max_bounces=max_bounces, differentiable=True)
        local = jnp.sum(rad**2) / (W * H * 3)
        return jax.lax.psum(jax.lax.psum(local, "tiles"), "spp")

    sharded_loss = jax.shard_map(
        local_loss,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(jax.value_and_grad(sharded_loss))(params, key)


def dryrun_grad_step(scene: Scene, mesh) -> None:
    """One sharded render->grad->Adam step over the mesh."""
    params = extract_params(scene)
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    loss, grads = sharded_loss_and_grad(scene, mesh, params,
                                        jax.random.PRNGKey(0))
    updates, opt_state = opt.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    jax.block_until_ready(params)
    assert float(loss) >= 0.0
