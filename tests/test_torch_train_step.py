"""The slice as a whole: the port's fused train step (clean pass,
masked-aug pass, render pass, one backward, one Adam step) against the JAX
package's `make_train_step`, on the CPU, at 64×64, V=3, 48/32/8 planes,
16 rays × 8 samples, 16 neural-volume planes.

The backbone is the golden trained one (tests/golden/backbone_synth.msgpack),
the render branch the JAX init; both are carried over through the weight
bridge, and the JAX step's own random draws (the mask rectangle from k_mask,
the ray pixels and depth noise from k_rays) are handed to the port. The JAX
optimizer is wrapped so that its state also keeps the gradient it was given
(test-side only). A trained backbone, because at a random init the depth is
flat, every |∇d| of the smoothness loss sits at the kink of |·| and its
gradient's sign is rounding noise (the port's own gradients then move 3 %
under 1e-7 parameter noise).

Tolerances, and why:
  * the total loss and its four terms (repr, w_aug·aug, img, ray depth),
    and the monitoring metrics: relative 1e-4 (absolute 1e-6 for 0);
  * the per-stage photometric components: relative 1e-3 (the sampler's
    validity mask is a floor, so a pixel may flip in or out of it);
  * parameter gradients: max|Δ| ≤ 1e-3 · max|g_jax| over the model that
    holds the parameter (backbone or render branch; the worst parameter
    sits at 1.7e-5 of it). Per tensor, the small gradients of deep BN
    layers are sums that cancel, and float32 rounding moves them by up to
    ~2 % of their own size in either framework (each stays within 1e-4 of
    itself under 1e-7 parameter noise; against a float64 run both err at
    1e-3–5e-2 there); the per-module tests hold each network's gradients
    per tensor at well-conditioned inputs;
  * BN running statistics: 1e-5 absolute + 1e-5 relative (JAX forms the
    batch variance as E[x²] − E[x]²);
  * the port's Adam on JAX's gradients gives JAX's parameters (1e-7); after
    the port's own step, parameters agree to 1e-5 wherever the gradient is
    above the noise floor (1e-3 of the network's scale; 35 % of the
    entries, worst 7.5e-9) and within 2·lr elsewhere (step 1 of Adam moves
    each weight by ≈ lr·sign(g), so a noise-level gradient whose sign
    differs moves it by 2·lr); at most 0.1 % of all entries may differ by
    more than 1e-5 (measured 779 of 1,360,180, 673 of them with the
    gradient's sign flipped).
Also: the port's train CLI on the CPU, and its refusals."""
import json
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rcmvsnet_tpu.train.step as jstep
from rcmvsnet_tpu.config import Config as JConfig
from rcmvsnet_tpu.config import RenderConfig as JRenderConfig
from rcmvsnet_tpu.config import RunConfig as JRunConfig
from rcmvsnet_tpu.data.synthetic import make_synthetic_batch
from rcmvsnet_tpu.train.state import create_train_state as jcreate
from rcmvsnet_tpu.train.state import make_optimizer as jmake_optimizer
from rcmvsnet_tpu_torch.cli import train as train_cli
from rcmvsnet_tpu_torch.config import Config, RenderConfig
from rcmvsnet_tpu_torch.render.rays import RayDraws
from rcmvsnet_tpu_torch.train.state import create_train_state
from rcmvsnet_tpu_torch.train.step import (StepDraws, batch_to,
                                           make_train_step)
from rcmvsnet_tpu_torch.weights import (render_state_dict_from_jax,
                                        state_dict_from_jax)

torch.set_num_threads(2)
H = W = 64
V = 3
N_RAYS, N_SAMPLES, PLANES = 16, 8, 16
GOLDEN = Path(__file__).resolve().parent / "golden" / "backbone_synth.msgpack"
TERMS = ("loss", "repr_loss", "aug_loss", "img_loss", "ray_depth_loss")
COMPONENTS = ("reconstr_loss", "ssim_loss", "smooth_loss", "depth_loss")
NETWORKS = ("feature.", "cost_regularization.0.", "cost_regularization.1.",
            "cost_regularization.2.", "render.MVSNet.", "render.network_fn.")


def _recording_optimizer(config, steps_per_epoch):
    """The JAX optimizer, with the gradient kept in its state."""
    tx, schedule = jmake_optimizer(config, steps_per_epoch)

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like,
                                                       params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update), schedule


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
        t = lambda a, dt=torch.float32: torch.from_numpy(
            np.array(a)).to(dt)
        rays.append(RayDraws(
            t(jax.random.randint(k_px, (N_RAYS,), 0, W), torch.int64),
            t(jax.random.randint(k_py, (N_RAYS,), 0, H), torch.int64),
            t(jax.random.normal(k_norm, (N_RAYS, N_SAMPLES))),
            t(jax.random.uniform(k_strat,
                                 (N_RAYS - N_RAYS // 2, N_SAMPLES)))))
    return StepDraws(torch.tensor(origins), tuple(rays))


def _port_tree(params, stats):
    """JAX {cascade, render} variables → the port's reference names."""
    return {**state_dict_from_jax(params["cascade"], stats["cascade"]),
            **{f"render.{k}": v for k, v in render_state_dict_from_jax(
                params["render"], stats["render"]).items()}}


@pytest.fixture(scope="module")
def steps():
    jcfg = JConfig(render=JRenderConfig(n_rays=N_RAYS, n_samples=N_SAMPLES,
                                        num_planes=PLANES),
                   run=JRunConfig(remat=False))
    batch = make_synthetic_batch(B=1, V=V, H=H, W=W, ndepth=64, seed=0)
    state = jcreate(jcfg, batch, 100, jax.random.PRNGKey(1))
    blob = flax.serialization.msgpack_restore(GOLDEN.read_bytes())
    state = state.replace(
        params={**state.params, "cascade": blob["params"]},
        batch_stats={**state.batch_stats, "cascade": blob["batch_stats"]})
    rng = jax.random.PRNGKey(7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "make_optimizer", _recording_optimizer)
        step = jax.jit(jstep.make_train_step(jcfg, 100))
        state = state.replace(opt_state=(
            state.opt_state,
            jax.tree_util.tree_map(jnp.zeros_like, state.params)))
        new_state, jmetrics = step(
            state, jax.tree_util.tree_map(jnp.asarray, batch), rng)
    jmetrics = {k: float(v) for k, v in jmetrics.items()}

    cfg = Config(render=RenderConfig(n_rays=N_RAYS, n_samples=N_SAMPLES,
                                     num_planes=PLANES))
    sd_c = state_dict_from_jax(state.params["cascade"],
                               state.batch_stats["cascade"])
    sd_r = render_state_dict_from_jax(state.params["render"],
                                      state.batch_stats["render"])
    pstate = create_train_state(cfg, V, 100, torch.device("cpu"),
                                state_dicts=(sd_c, sd_r))
    pmetrics = make_train_step(cfg)(pstate, batch_to(batch, "cpu"),
                                    _jax_draws(rng, 1))
    pmetrics = {k: float(v) for k, v in pmetrics.items()}
    port = {f"render.{k}": v for k, v in pstate.render.named_parameters()}
    port.update(dict(pstate.cascade.named_parameters()))
    buffers = {f"render.{k}": v for k, v in pstate.render.named_buffers()}
    buffers.update(dict(pstate.cascade.named_buffers()))
    jax_grads = _port_tree(new_state.opt_state[1], new_state.batch_stats)

    # the port's optimizer alone, fed JAX's gradients
    again = create_train_state(cfg, V, 100, torch.device("cpu"),
                               state_dicts=(sd_c, sd_r))
    named = {f"render.{k}": v for k, v in again.render.named_parameters()}
    named.update(dict(again.cascade.named_parameters()))
    for name, p in named.items():
        p.grad = jax_grads[name].clone()
    for group in again.optimizer.param_groups:
        group["lr"] = again.schedule(0)
    again.optimizer.step()
    return {
        "jax_metrics": jmetrics, "port_metrics": pmetrics,
        "jax_grads": jax_grads,
        "jax_after": _port_tree(new_state.params, new_state.batch_stats),
        "port_params": port, "port_buffers": buffers,
        "adam_on_jax_grads": named, "lr": again.schedule(0),
    }


def _scale(grads, name, groups=NETWORKS):
    """max|g| over the group of `name` (a network, or a model)."""
    net = next(n for n in groups if name.startswith(n))
    return max(float(np.abs(g.numpy()).max()) for k, g in grads.items()
               if k.startswith(net) and "running" not in k
               and "num_batches" not in k)


def test_losses_match_jax(steps):
    jm, pm = steps["jax_metrics"], steps["port_metrics"]
    assert set(jm) <= set(pm), sorted(set(jm) - set(pm))
    for k in TERMS:
        assert np.isfinite(pm[k]) and pm[k] != 0.0, k
    for k in jm:
        rtol = 1e-3 if k.startswith(COMPONENTS) else 1e-4
        np.testing.assert_allclose(pm[k], jm[k], rtol=rtol, atol=1e-6,
                                   err_msg=k)


def test_parameter_gradients_match_jax(steps):
    want = steps["jax_grads"]
    params = steps["port_params"]
    assert set(params) <= set(want)
    for name, p in params.items():
        assert p.grad is not None, f"{name}: no gradient"
        err = float(np.abs(p.grad.numpy() - want[name].numpy()).max())
        scale = _scale(want, name, ("render.", ""))
        assert err <= 1e-3 * scale, (name, err, scale)


def test_bn_running_stats_match_jax(steps):
    want = steps["jax_after"]
    n = 0
    for name, buf in steps["port_buffers"].items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
            n += 1
    assert n == 2 * (8 + 3 * 10 + 10)      # FeatureNet, 3 U-Nets, render


def test_adam_matches_optax(steps):
    """torch Adam (L2 weight decay, eps outside the root) on JAX's
    gradients reproduces optax's first update."""
    want = steps["jax_after"]
    for name, p in steps["adam_on_jax_grads"].items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-7, err_msg=name)


def test_params_after_adam_match_jax(steps):
    want, grads = steps["jax_after"], steps["jax_grads"]
    lr = steps["lr"]
    n_all = n_off = 0
    for name, p in steps["port_params"].items():
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        clear = np.abs(grads[name].numpy()) >= 1e-3 * _scale(grads, name)
        assert float(diff[clear].max(initial=0.0)) <= 1e-5, name
        assert float(diff.max()) <= 2 * lr * (1 + 1e-3), name
        n_all += diff.size
        n_off += int((diff > 1e-5).sum())
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


def test_train_cli_one_step_on_cpu(tmp_path):
    train_cli.main(["--trainpath", "synthetic", "--max_steps", "2",
                    "--epochs", "1", "--device", "cpu", "--num_view", "2",
                    "--logdir", str(tmp_path), "--summary_freq", "1"])
    recs = [json.loads(line) for line in
            (tmp_path / "scalars.jsonl").read_text().splitlines()]
    train = [r for r in recs if r["mode"] == "train"]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in train)
    assert {"fulltrain"} <= {r["mode"] for r in recs}


@pytest.mark.parametrize("profile_steps,traced", [(1, 1), (5, 2)])
def test_train_cli_writes_profile_trace(tmp_path, profile_steps, traced):
    """--profile_steps N traces N train steps from step 3 into
    <logdir>/profile/trace.json; when the epoch ends first (5 steps, N=5)
    the trace is flushed at its end with the steps it holds."""
    train_cli.main(["--trainpath", "synthetic", "--max_steps", "5",
                    "--epochs", "1", "--device", "cpu", "--num_view", "2",
                    "--numdepth", "16", "--n_rays", "64", "--n_samples", "16",
                    "--summary_freq", "100", "--profile_steps",
                    str(profile_steps), "--logdir", str(tmp_path)])
    trace = json.loads((tmp_path / "profile" / "trace.json").read_text())
    steps = [e for e in trace["traceEvents"]
             if e.get("name") == "train_step" and e.get("ph") == "X"]
    assert len(steps) == traced


def test_train_cli_refuses_missing_cuda_and_builds_dtu_sets(tmp_path,
                                                          monkeypatch):
    """Without a card and without --device cpu the CLI refuses to run. With
    a DTU trainpath (the cameras of a 3-view tree; the loop itself is
    patched out, a DTU step on the CPU being too slow here) it hands
    `fit` the DTU train and val sets and the config its flags give."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_cli.main(["--trainpath", "synthetic", "--logdir",
                        str(tmp_path)])

    from rcmvsnet_tpu_torch.core.io import write_cam_file, write_pair_file
    from rcmvsnet_tpu_torch.data.dtu_train import DTUTrainDataset
    from rcmvsnet_tpu_torch.data.dtu_val import DTUValDataset
    root = tmp_path / "dtu"
    (root / "Cameras" / "train").mkdir(parents=True)
    for v in range(3):
        write_cam_file(root / "Cameras" / "train" / f"{v:08d}_cam.txt",
                       np.eye(4, dtype=np.float32),
                       np.eye(3, dtype=np.float32), [425.0, 2.5])
    write_pair_file(root / "Cameras" / "pair.txt",
                    [(v, [u for u in range(3) if u != v]) for v in range(3)])
    (tmp_path / "train.txt").write_text("scan1\nscan2\n")
    (tmp_path / "test.txt").write_text("scan3\n")
    seen = {}
    monkeypatch.setattr(train_cli, "fit", lambda *a, **kw: seen.update(
        args=a, kw=kw))
    train_cli.main(["--trainpath", str(root), "--testpath", str(root),
                    "--trainlist", str(tmp_path / "train.txt"),
                    "--testlist", str(tmp_path / "test.txt"),
                    "--num_view", "2", "--numdepth", "64",
                    "--interval_scale", "1.2", "--batch_size", "2",
                    "--net_type", "v1", "--epochs", "4", "--save_freq", "2",
                    "--eval_freq", "3", "--resume", "--profile_steps", "2",
                    "--max_steps", "5", "--random_seed", "7",
                    "--device", "cpu", "--logdir", str(tmp_path / "log")])
    config, train_ds, val_ds, device = seen["args"]
    assert seen["kw"] == {"resume": True, "max_steps": 5,
                          "profile_steps": 2, "plain": False}
    assert device == torch.device("cpu")
    assert isinstance(train_ds, DTUTrainDataset)
    assert isinstance(val_ds, DTUValDataset)
    assert (train_ds.nviews, train_ds.ndepths, train_ds.interval_scale) \
        == (3, 64, 1.2)
    assert (val_ds.nviews, val_ds.ndepths, val_ds.interval_scale) == \
        (5, 64, 1.2)
    assert {m[0] for m in train_ds.metas} == {"scan1", "scan2"}
    assert len(train_ds) == 2 * 3 * 7
    assert {m[0] for m in val_ds.metas} == {"scan3"}
    assert config.render.net_type == "v1" and config.render.n_rays == 1024
    assert (config.data.datapath, config.data.testpath) == (str(root),
                                                            str(root))
    assert (config.data.train_list, config.data.test_list) == (
        str(tmp_path / "train.txt"), str(tmp_path / "test.txt"))
    assert (config.run.epochs, config.run.save_freq, config.run.eval_freq,
            config.run.seed) == (4, 2, 3, 7)
    train_dl, val_dl = train_cli.make_loaders(config, train_ds, val_ds)
    assert (train_dl.batch_size, train_dl.shuffle, train_dl.seed) == \
        (2, True, 7)
    assert (val_dl.batch_size, val_dl.shuffle, val_dl.drop_last) == \
        (2, False, False)
    assert len(train_dl) == 21 and len(val_dl) == 11
