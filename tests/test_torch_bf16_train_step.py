"""The PyTorch port's bf16 train step (`BackboneConfig.train_dtype` =
"bfloat16") against the JAX package's, end to end, on the CPU.

The JAX step runs `make_train_step` with train_dtype bf16 (backbone and
render U-Net) and the fused flags on as the JAX CLI sets them on its chip
(`cli/train.py:200-222`; `ray_major_lookup` aside: not ported), its Pallas
kernels in interpret mode, its bf16 `reduce_sum` accumulated in float32
and each bf16 operation rounded (`tests/test_torch_bf16_train.py`:
`f32_reductions`, `jit`). The port runs its bf16
plain versions. Shape: 32×32, V=3, ndepths 8/8/8, 32 rays × 8 samples, 16
planes (`tests/test_train_bf16.py:19-29`), from the golden backbone and
the JAX render init with its MLP scaled by 1/8, with JAX's own draws.

This is the end-to-end check. What holds each piece to JAX's rounding at
the scale of one bf16 ulp is `tests/test_torch_bf16_train.py`: the
kernels, and each FeatureNet and U-Net block fed JAX's own inputs and
cotangents. A chained bf16 network cannot agree that closely with another
implementation of the same rounding: the two sum each conv in another
order, which flips the bf16 rounding of an element now and then, and the
flips multiply layer by layer (one input element moved by one ulp moves
a U-Net's input gradient by 1.6 % relative L2 at the golden weights), so
the step is held at the scale of those flips:

  * each loss term within 5e-3 relative (ten times tighter than JAX's own
    bf16-vs-f32 budget, 5e-2); measured ≤ 7.9e-4, the repr term;
  * the clean pass's depth within 2e-3 of JAX's, relative, at every pixel
    (measured 4.5e-4) and its stage-1 volume (warped images and no-ref
    variance, bf16) within one bf16 ulp + 1e-4 of its largest value at
    all but 1e-3 of its elements (measured: every element);
  * every gradient element within 5e-2 of its model's largest (measured
    3.4e-2, FeatureNet's conv0.1 weight, in the cascade; 1.1e-2 in the
    render branch). The port's own step with ONE weight nudged by one
    bf16 ulp moves it by 0.26 and 0.031 of those: the 2e-2 first planned
    lies inside that scatter;
  * per network, the gradient within 0.15 relative L2 of JAX's (measured:
    FeatureNet 0.045, the U-Nets 0.010–0.049, the render U-Net 0.093, the
    render MLP 0.011) and within twice the port's own response to that
    nudge plus 2e-2 (nudge: 0.33, 0.082–0.13, 0.25, 0.031);
  * the running statistics within 1e-3 of the network's largest statistic
    (measured ≤ 5.4e-4, the render U-Net; the nudge moves them by up to
    8.0e-4), parameters, BN buffers, Adam's moments and the depth float32.

Before the JAX reference was compiled as above (bf16 sums accumulated in
bf16, fused bf16 chains in float32), FeatureNet's gradient sat 0.47 from
the port's in relative L2 and the render U-Net's 0.28.

The render MLP is scaled by 1/8: at its init, the losses sample the
neural volume at depths drawn around the pseudo-depth and encode them at
frequencies up to 2^9, so one ray's rendered depth moved by 35 units
between the two packages' clean-pass depths, which agree to 2.7e-4; fed
identical inputs, the render pass agrees with JAX's to 1.3e-7. The JAX
step takes ≈ 2.5 min to trace and compile in interpret mode on one CPU
core, most of this file's time.
"""
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rcmvsnet_tpu.train.step as jstep
from rcmvsnet_tpu.config import BackboneConfig as JBackboneConfig
from rcmvsnet_tpu.config import Config as JConfig
from rcmvsnet_tpu.config import RenderConfig as JRenderConfig
from rcmvsnet_tpu.config import RunConfig as JRunConfig
from rcmvsnet_tpu.data.synthetic import make_synthetic_batch
from rcmvsnet_tpu.train.state import make_models as jmake_models
from rcmvsnet_tpu.train.state import make_optimizer as jmake_optimizer
from rcmvsnet_tpu_torch.config import (BackboneConfig, Config, RenderConfig,
                                       RunConfig)
from rcmvsnet_tpu_torch.render.rays import RayDraws
from rcmvsnet_tpu_torch.train.state import create_train_state
from rcmvsnet_tpu_torch.train.step import (StepDraws, batch_to,
                                           make_train_step)
from rcmvsnet_tpu_torch.weights import (render_state_dict_from_jax,
                                        state_dict_from_jax)
from tests.test_torch_bf16_train import f32_reductions, interpret, jit

torch.set_num_threads(2)
GOLDEN = Path(__file__).resolve().parent / "golden" / "backbone_synth.msgpack"
H = W = 32
V = 3
NDEPTHS = (8, 8, 8)
N_RAYS, N_SAMPLES, PLANES = 32, 8, 16
TERMS = ("loss", "repr_loss", "aug_loss", "img_loss", "ray_depth_loss")
NETWORKS = ("feature.", "cost_regularization.0.", "cost_regularization.1.",
            "cost_regularization.2.", "render.MVSNet.", "render.network_fn.")
LOSS_RTOL = 5e-3          # each term, bf16 port step vs bf16 JAX step
DEPTH_RTOL = 2e-3         # clean-pass depth, every pixel
VOLUME_SHARE = 1e-3       # volume elements allowed beyond one bf16 ulp
GRAD_ELEM = 5e-2          # × the model's largest gradient element
GRAD_NET = 0.15           # relative L2 per network
GRAD_FLOOR, GRAD_ATOL = 2.0, 2e-2   # × the one-ulp nudge's distance, + this
STATS_TOL = 1e-3          # × the network's largest running statistic
NERF_SCALE = 0.125        # the render MLP's weights and biases, scaled
                          # (a smooth field: see the module doc)
NUDGED = "feature.conv0.0.conv.weight"     # its first element, one ulp


def _jax_draws(rng, B):
    """The draws the JAX step makes from rng (train/step.py:93,
    losses/aug.py:37-40, render/rays.py:52-90)."""
    k_mask, k_rays = jax.random.split(rng)
    fh, fw = H // 3, W // 3
    origins = []
    for k in jax.random.split(k_mask, B):
        kx, ky = jax.random.split(k)
        origins.append([int(jax.random.randint(kx, (), 0, W - fw)),
                        int(jax.random.randint(ky, (), 0, H - fh))])
    rays = []
    for k in jax.random.split(k_rays, B):
        k_px, k_py, k_norm, k_strat = jax.random.split(k, 4)
        t = lambda a, dt=torch.float32: torch.from_numpy(np.array(a)).to(dt)
        rays.append(RayDraws(
            t(jax.random.randint(k_px, (N_RAYS,), 0, W), torch.int64),
            t(jax.random.randint(k_py, (N_RAYS,), 0, H), torch.int64),
            t(jax.random.normal(k_norm, (N_RAYS, N_SAMPLES))),
            t(jax.random.uniform(k_strat,
                                 (N_RAYS - N_RAYS // 2, N_SAMPLES)))))
    return StepDraws(torch.tensor(origins), tuple(rays))


def _recording_optimizer(config, steps_per_epoch):
    """JAX's optimizer, its state also carrying the step's gradient."""
    import optax
    tx, schedule = jmake_optimizer(config, steps_per_epoch)

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like,
                                                       params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update), schedule


def _capturing_models(captured: dict):
    """JAX's `make_models` with the clean pass's depth and stage-1 volume
    sent to `captured` as the jitted step runs."""
    def make(config):
        cascade, render = jmake_models(config)

        class Capturing:
            def apply(self, *args, **kw):
                out = cascade.apply(*args, **kw)
                if kw.get("return_volume"):
                    (outputs, volume), _ = out
                    jax.debug.callback(
                        lambda v, d: captured.update(
                            volume=np.asarray(v, np.float32),
                            depth=np.asarray(d)),
                        volume.astype(jnp.float32), outputs["depth"])
                return out
        return Capturing(), render
    return make


def _tree(p, s) -> dict:
    """JAX {cascade, render} variables → the port's reference names."""
    return {**state_dict_from_jax(p["cascade"], s["cascade"]),
            **{f"render.{k}": v for k, v in render_state_dict_from_jax(
                p["render"], s["render"]).items()}}


def jax_step():
    """One bf16 step of the JAX package from the golden backbone and a
    jitted render init: (batch, rng, the initial variables, metrics, the
    clean pass's depth and volume, the gradient and the variables after
    the step in the port's names)."""
    jcfg = JConfig(
        backbone=JBackboneConfig(
            ndepths=NDEPTHS, train_dtype="bfloat16",
            pallas_warp_max_bytes=1 << 30,
            pallas_warp_band=(H // 4, H // 2, H),
            pallas_warp_rows=4, pallas_warp_train=True,
            pallas_costreg_train=True),
        render=JRenderConfig(n_rays=N_RAYS, n_samples=N_SAMPLES,
                             num_planes=PLANES, pallas_costreg_train=True,
                             train_dtype="bfloat16"),
        run=JRunConfig(remat=False))
    batch = make_synthetic_batch(B=1, V=V, H=H, W=W, ndepth=NDEPTHS[0],
                                 seed=0)
    fed = jax.tree_util.tree_map(jnp.asarray, batch)
    blob = flax.serialization.msgpack_restore(GOLDEN.read_bytes())
    _, render = jmake_models(jcfg)
    vol_ch = 3 * (V - 1) + 32
    rnd = jax.jit(lambda k: render.init(
        k, jnp.zeros((1, NDEPTHS[0], H // 4, W // 4, vol_ch)),
        jnp.ones((1, H, W)),
        fed["imgs"], fed["w2cs"], fed["c2ws"], fed["intrinsics"],
        fed["near_fars"], rng=k, train=False))(jax.random.PRNGKey(3))
    # the render MLP scaled to a smooth field (see the module doc)
    nerf = jax.tree_util.tree_map(lambda a: a * NERF_SCALE,
                                  rnd["params"]["nerf"])
    params = {"cascade": blob["params"],
              "render": {**rnd["params"], "nerf": nerf}}
    stats = {"cascade": blob["batch_stats"], "render": rnd["batch_stats"]}
    rng = jax.random.PRNGKey(7)
    captured = {}
    with pytest.MonkeyPatch.context() as mp:
        interpret(mp)
        f32_reductions(mp)
        mp.setattr(jstep, "make_optimizer", _recording_optimizer)
        mp.setattr(jstep, "make_models", _capturing_models(captured))
        tx, _ = _recording_optimizer(jcfg, 100)
        state = jstep.TrainState(step=jnp.asarray(0, jnp.int32),
                                 params=params, batch_stats=stats,
                                 opt_state=tx.init(params))
        step = jit(jstep.make_train_step(jcfg, 100))
        new_state, jm = step(state, fed, rng)
        jax.block_until_ready(jm)
    return {"batch": batch, "rng": rng, "init": _tree(params, stats),
            "jax_metrics": {k: float(v) for k, v in jm.items()},
            "jax_clean": captured,
            "jax_grads": _tree(new_state.opt_state[1],
                               new_state.batch_stats),
            "jax_after": _tree(new_state.params, new_state.batch_stats)}


def port_step(jax_out: dict) -> dict:
    """The port's bf16 step (plain, CPU) from the JAX step's initial
    variables, batch and draws, and its clean pass's depth and volume."""
    cfg = Config(backbone=BackboneConfig(ndepths=NDEPTHS,
                                         train_dtype="bfloat16"),
                 render=RenderConfig(n_rays=N_RAYS, n_samples=N_SAMPLES,
                                     num_planes=PLANES),
                 run=RunConfig())
    init = jax_out["init"]
    sd_c = {k: v for k, v in init.items() if not k.startswith("render.")}
    sd_r = {k[len("render."):]: v for k, v in init.items()
            if k.startswith("render.")}
    tb = batch_to(jax_out["batch"], "cpu")
    new = lambda: create_train_state(cfg, V, 100, torch.device("cpu"),
                                     state_dicts=(sd_c, sd_r))
    with torch.no_grad():   # the step's clean pass (train-mode BN)
        out, volume = new().cascade.forward_train(
            tb["imgs"], tb["proj_matrices"], tb["depth_values"],
            return_volume=True)
    pstate = new()
    pm = make_train_step(cfg)(pstate, tb,
                                          _jax_draws(jax_out["rng"], 1))
    port = {f"render.{k}": v for k, v in pstate.render.named_parameters()}
    port.update(dict(pstate.cascade.named_parameters()))
    buffers = {f"render.{k}": v for k, v in pstate.render.named_buffers()}
    buffers.update(dict(pstate.cascade.named_buffers()))
    return {"port_metrics": {k: float(v) for k, v in pm.items()},
            "depth": out["depth"], "volume": volume,
            "port_params": port, "port_buffers": buffers,
            "optimizer": pstate.optimizer}


def _nets(names):
    """Parameter or buffer names grouped by network."""
    return {net: [n for n in names if n.startswith(net)] for net in NETWORKS}


@pytest.fixture(scope="module")
def steps():
    """One bf16 step of each package from the same state and draws, and
    the port's step again with one weight nudged by a bf16 ulp (its
    first element times 1 + 2^-7)."""
    out = jax_step()
    init = dict(out["init"])
    w = init[NUDGED].clone()
    w.view(-1)[0] *= 1 + 2.0 ** -7
    init[NUDGED] = w
    return {**out, **port_step(out),
            "nudged": port_step({**out, "init": init})}


def test_bf16_step_losses_match_jax(steps):
    jm, pm = steps["jax_metrics"], steps["port_metrics"]
    for k in TERMS:
        assert np.isfinite(pm[k]) and pm[k] != 0.0, k
        assert abs(pm[k] - jm[k]) <= LOSS_RTOL * abs(jm[k]), (k, pm[k],
                                                              jm[k])


def test_bf16_step_clean_pass_matches_jax(steps):
    """The cascade's bf16 train forward inside the step: depth (float32)
    within DEPTH_RTOL relative at every pixel, the stage-1 volume (bf16,
    [B, 3(V−1)+C, D, h, w]) within one bf16 ulp + 1e-4 of its largest
    value at all but VOLUME_SHARE of its elements."""
    want = steps["jax_clean"]
    depth, volume = steps["depth"], steps["volume"]
    assert depth.dtype == torch.float32 and volume.dtype == torch.bfloat16
    rel = np.abs(depth.numpy() - want["depth"]) / np.abs(want["depth"])
    assert rel.max() <= DEPTH_RTOL, float(rel.max())
    v = volume.float().permute(0, 2, 3, 4, 1).numpy()
    w = want["volume"]
    assert v.shape == w.shape, (v.shape, w.shape)
    over = np.abs(v - w) > 2.0 ** -7 * np.abs(w) + 1e-4 * np.abs(w).max()
    assert over.mean() <= VOLUME_SHARE, float(over.mean())


def _rel_l2(a: list, b: list) -> float:
    """‖a − b‖₂ / ‖b‖₂ over the concatenated tensors."""
    a, b = torch.cat([t.ravel() for t in a]), torch.cat([t.ravel()
                                                         for t in b])
    return float((a - b).norm() / b.norm())


def test_bf16_step_gradients_match_jax(steps):
    """Every gradient element within GRAD_ELEM of its model's (cascade,
    render) largest; per network, the relative L2 distance to JAX's
    within GRAD_NET, and within twice the port's own response to the
    one-ulp nudge, plus GRAD_ATOL."""
    want = steps["jax_grads"]
    port, nudged = steps["port_params"], steps["nudged"]["port_params"]
    for p in port.values():
        assert p.grad is not None and p.grad.dtype == torch.float32
    for model in ("cascade", "render"):
        names = [n for n in port if n.startswith("render.")
                 == (model == "render")]
        scale = max(float(want[n].abs().max()) for n in names)
        err = max(float((port[n].grad - want[n]).abs().max())
                  for n in names)
        assert err <= GRAD_ELEM * scale, (model, err, scale)
    for net, names in _nets(list(port)).items():
        got = [port[n].grad for n in names]
        err = _rel_l2(got, [want[n] for n in names])
        floor = _rel_l2([nudged[n].grad for n in names], got)
        assert err <= GRAD_NET, (net, err)
        assert err <= GRAD_FLOOR * floor + GRAD_ATOL, (net, err, floor)


def test_bf16_step_bn_stats_and_dtypes(steps):
    """Running statistics per network: max |Δ| against JAX's within
    STATS_TOL of the network's largest statistic; parameters, BN
    buffers, Adam's moments and the depth float32."""
    want = steps["jax_after"]
    port = steps["port_buffers"]
    stats = [n for n in port if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * (8 + 3 * 10 + 10)  # FeatureNet, U-Nets, render
    for net, names in _nets(stats).items():
        if not names:
            continue
        scale = max(float(want[n].abs().max()) for n in names)
        err = max(float((port[n] - want[n]).abs().max()) for n in names)
        assert all(port[n].dtype == torch.float32 for n in names)
        assert err <= STATS_TOL * scale, (net, err, scale)
    assert all(p.dtype == torch.float32
               for p in steps["port_params"].values())
    for st in steps["optimizer"].state.values():
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
    assert steps["depth"].dtype == torch.float32
