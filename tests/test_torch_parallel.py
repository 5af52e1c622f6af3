"""Data parallelism of the port (`rcmvsnet_tpu_torch/parallel/`), on the
CPU: two ranks over Gloo, started by `parallel/mesh.spawn` (start method
"spawn", one process per rank, meeting through a FileStore in a fresh
directory, never a TCP port) or, for the CLIs, by the CLI in a subprocess
of its own session. Every multi-process test kills its workers at its own
timeout (TIMEOUT seconds: `spawn`'s timeout, `communicate`'s for the
CLIs, which then kills the whole process group).

What each test holds, at tiny shapes (V=3, 32 rays × 8 samples, 16 planes;
the loss terms at 32×32, the train step at 64×64 with the golden
backbone's ndepths 48/32/8):
  * the cross-rank BatchNorm (`parallel/sync_bn`) over 2 ranks equals the
    JAX package's `TorchBatchNorm` on the concatenated batch: output,
    input gradient, the scale and bias gradients (summed over the ranks)
    and the running mean and variance within 1e-5;
  * every loss term over 2 ranks (B=1 each), averaged over the ranks as
    the train step averages its metrics, equals the JAX loss function at
    B=2 within 1e-6 relative; each rank's
    gradient of their sum with respect to its own inputs (its backward of
    its copy of the global sum: world × its share, `parallel/mesh.py`),
    over the world size, equals the rows of the single-process port's at
    B=2 within 1e-6 of the largest, and
    JAX's within 1e-5 (the photometric warps' bilinear sampling rounds
    differently in the two frameworks); the two samples have different
    mask counts, and the per-rank masked means averaged over the ranks
    miss JAX's by more than 1e-6;
  * a 2-rank train step at B=1 each (the golden backbone, the plain path)
    equals the single-process port step at B=2 on the same global batch
    and draws, its BatchNorms the cross-rank layer's at one rank
    (`sync_bn.convert(..., one_rank=True)`, as `chip_smoke.py` phase 11
    holds the card's ranks; the loss terms are also held to the step with
    PyTorch's own BatchNorm within 1e-5): the loss and its four terms
    within 1e-5 relative, the
    photometric components within 1e-3 (the sampler's validity mask is a
    floor, so a pixel may flip in or out of it; `test_torch_train_step`
    holds them so against JAX) and the other metrics within 1e-5; every
    gradient within 1e-5 of the step's largest (the render branch's) and
    within 1e-4 of its own model's largest (measured 1.2e-5 for the
    backbone, 2.6e-6 for the render branch: the backbone's gradients move
    1.3e-5 of its largest under 1e-7 relative parameter noise, so 1e-5 of
    its own largest would sit on float32's floor); the BN running
    statistics within 1e-5; both ranks' parameters and buffers after Adam
    equal in every bit. At ndepths 8/8/8 the golden backbone is out of
    the regime it was trained in and its gradients are noise (8 % of the
    largest between the two runs);
  * `cli.train --n_devices 2 --device cpu --trainpath synthetic`: the
    banner says "2 devices / 2 process(es)", rank 0 alone writes the
    `*_cas.ckpt` / `*_nerf.ckpt` pair, the scalars and the step lines
    (each step once); a 2-rank `--resume` from a copy of that logdir per
    rank resumes, and with one rank's copy altered it is refused;
  * `cli.eval_dtu --n_devices 2 --device cpu` writes depth and confidence
    files byte-identical to `--n_devices 1`, and fuses.
"""
import json
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rcmvsnet_tpu_torch.config import Config, RenderConfig, BackboneConfig
from rcmvsnet_tpu_torch.data.synthetic import make_synthetic_batch
from rcmvsnet_tpu_torch.parallel import mesh
from rcmvsnet_tpu_torch.parallel.sync_bn import CrossRankBatchNorm

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 240
WORLD = 2
H = W = 32              # the loss terms' inputs
SH = SW = 64            # the train step's, at the golden backbone's planes
V = 3
CFG = Config(backbone=BackboneConfig(ndepths=(48, 32, 8)),
             render=RenderConfig(n_rays=32, n_samples=8, num_planes=16))


def _spawn(fn, *args):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        mesh.spawn(fn, WORLD, args, device_type="cpu", timeout=TIMEOUT)


def _rows(tree, r, b=1):
    """Rows [r·b, (r+1)·b) of every batch-major array of a (nested) dict;
    0-d entries are kept."""
    if isinstance(tree, dict):
        return {k: _rows(v, r, b) for k, v in tree.items()}
    return tree[r * b:(r + 1) * b] if np.ndim(tree) else tree


def _run_cli(args, cwd, timeout=TIMEOUT):
    """Run `python -m <args>` in a session of its own; on timeout kill the
    whole process group (the CLI and the workers it spawned)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", *args], cwd=cwd,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-4000:]
    return out


# ----------------------------------------------------------------- BN ----

def _bn_inputs():
    rng = np.random.default_rng(11)
    cases = {}
    for name, shape in (("2d", (4, 5, 6, 8)), ("3d", (2, 4, 4, 6, 8))):
        C = shape[1]
        cases[name] = {
            "x": (2 + 3 * rng.standard_normal(shape)).astype(np.float32),
            "g": rng.standard_normal(shape).astype(np.float32),
            "weight": (1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(C)).astype(np.float32),
            "mean": (0.1 * rng.standard_normal(C)).astype(np.float32),
            "var": (1 + 0.1 * rng.random(C)).astype(np.float32)}
    return cases


def _rank_bn(rank, world, device, cases, out):
    res = {}
    for name, c in cases.items():
        b = c["x"].shape[0] // world
        bn = CrossRankBatchNorm(c["x"].shape[1], group=mesh.batch_group())
        with torch.no_grad():
            for k, key in (("weight", "weight"), ("bias", "bias"),
                           ("running_mean", "mean"),
                           ("running_var", "var")):
                getattr(bn, k).copy_(torch.from_numpy(c[key]))
        x = torch.from_numpy(_rows(c["x"], rank, b)).requires_grad_(True)
        y = bn(x)
        (y * torch.from_numpy(_rows(c["g"], rank, b))).sum().backward()
        res[name] = {"y": y.detach(), "dx": x.grad,
                     "dweight": bn.weight.grad, "dbias": bn.bias.grad,
                     "mean": bn.running_mean.clone(),
                     "var": bn.running_var.clone()}
    torch.save(res, Path(out) / f"bn{rank}.pt")


def _jax_bn(c):
    import jax
    import jax.numpy as jnp

    from rcmvsnet_tpu.nn.layers import TorchBatchNorm
    last = lambda a: np.moveaxis(a, 1, -1)
    bn = TorchBatchNorm()
    stats = {"mean": jnp.asarray(c["mean"]), "var": jnp.asarray(c["var"])}

    def f(x, scale, bias):
        y, new = bn.apply({"params": {"scale": scale, "bias": bias},
                           "batch_stats": stats}, x, train=True,
                          mutable=["batch_stats"])
        return y, new["batch_stats"]

    (y, new), vjp = jax.vjp(f, jnp.asarray(last(c["x"])),
                            jnp.asarray(c["weight"]), jnp.asarray(c["bias"]))
    dx, dscale, dbias = vjp((jnp.asarray(last(c["g"])),
                             jax.tree_util.tree_map(jnp.zeros_like, new)))
    first = lambda a: np.moveaxis(np.asarray(a), -1, 1)
    return {"y": first(y), "dx": first(dx), "dweight": np.asarray(dscale),
            "dbias": np.asarray(dbias), "mean": np.asarray(new["mean"]),
            "var": np.asarray(new["var"])}


def test_sync_bn_matches_jax_on_the_global_batch(tmp_path):
    cases = _bn_inputs()
    _spawn(_rank_bn, cases, str(tmp_path))
    ranks = [torch.load(tmp_path / f"bn{r}.pt") for r in range(WORLD)]
    for name, c in cases.items():
        want = _jax_bn(c)
        got = {k: torch.cat([r[name][k] for r in ranks]).numpy()
               for k in ("y", "dx")}
        got.update({k: sum(r[name][k] for r in ranks).numpy()
                    for k in ("dweight", "dbias")})
        got.update({k: ranks[0][name][k].numpy() for k in ("mean", "var")})
        for k in ("mean", "var"):
            assert torch.equal(ranks[0][name][k], ranks[1][name][k]), k
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} {k}")


# -------------------------------------------------------------- losses ----

def _loss_inputs():
    """A B=2 batch whose samples have different mask counts in every
    masked term, and depth estimates near the synthetic ground truth."""
    rng = np.random.default_rng(5)
    b = make_synthetic_batch(B=2, V=V, H=H, W=W, ndepth=32, seed=3)
    est = {k: (d * (1 + 0.02 * rng.standard_normal(d.shape)))
           .astype(np.float32) for k, d in b["depth"].items()}
    share = np.array([0.3, 0.8])[:, None, None]    # of pixels kept
    mask = {k: (rng.random(m.shape) < share).astype(np.float32)
            for k, m in b["mask"].items()}
    fm = np.ones((2, H, W, 3), np.float32)
    fm[0, 4:20, 6:30] = 0.0                       # a large hole
    fm[1, 10:14, 2:7] = 0.0                       # a small one
    R = 32
    rays_gt = (600 + 20 * rng.standard_normal((2, R))).astype(np.float32)
    rays_gt[0, :5] = 0.0                          # 5 empty rays, then 21
    rays_gt[1, :21] = 0.0
    return {"center_imgs": b["center_imgs"], "proj": b["proj_matrices"],
            "est": est, "gt": b["depth"], "mask": mask, "filter_mask": fm,
            "pseudo": b["depth"]["stage3"],
            "rays_pred": (rays_gt + 3 * rng.standard_normal((2, R)))
            .astype(np.float32),
            "rays_gt": rays_gt,
            "rgb": rng.random((2, R, 3)).astype(np.float32),
            "rgb_gt": rng.random((2, R, 3)).astype(np.float32)}


MASKED = ("aug", "sl1", "abs_error", "acc_2mm", "cas")


def _port_terms(x, group):
    """Every loss term and metric of the step on tensors x (the est
    depths and rays_pred require grad); returns {name: 0-d tensor}."""
    from rcmvsnet_tpu_torch.losses.aug import aug_loss_multi_stage
    from rcmvsnet_tpu_torch.losses.rays import (abs_error, acc_threshold,
                                                img2mse, sl1_loss)
    from rcmvsnet_tpu_torch.losses.supervised import (
        abs_depth_error_metric, cas_mvsnet_loss, thres_metric)
    from rcmvsnet_tpu_torch.losses.unsup import unsup_loss_multi_stage
    outs = {k: {"depth": v} for k, v in x["est"].items()}
    ray_mask = x["rays_gt"] > 0
    m3 = x["mask"]["stage3"] > 0.5
    return {
        "unsup": unsup_loss_multi_stage(outs, x["center_imgs"], x["proj"],
                                        group=group)[0],
        "aug": aug_loss_multi_stage(outs, x["pseudo"], x["filter_mask"],
                                    group=group)[0],
        "sl1": sl1_loss(x["rays_pred"], x["rays_gt"], ray_mask, group),
        "img2mse": img2mse(x["rgb"], x["rgb_gt"]),
        "abs_error": abs_error(x["rays_pred"], x["rays_gt"], ray_mask,
                               group),
        "acc_2mm": acc_threshold(x["rays_pred"], x["rays_gt"], ray_mask,
                                 2.0, group),
        "cas": cas_mvsnet_loss(outs, x["gt"], x["mask"], group=group)[0],
        "thres2mm": thres_metric(x["est"]["stage3"], x["gt"]["stage3"], m3,
                                 2.0),
        "abs_depth": abs_depth_error_metric(x["est"]["stage3"],
                                            x["gt"]["stage3"], m3)}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def _loss_and_grads(inputs, group):
    """The terms' values, averaged over the ranks as the train step
    averages its metrics (`mesh.average_scalars`), and the gradients of
    the losses' sum with respect to the depth estimates and the rays'
    depths."""
    x = _to_torch(inputs)
    for v in list(x["est"].values()) + [x["rays_pred"]]:
        v.requires_grad_(True)
    terms = _port_terms(x, group)
    sum(terms[k] for k in ("unsup", "aug", "sl1", "img2mse",
                           "cas")).backward()
    grads = {k: v.grad for k, v in x["est"].items()}
    grads["rays"] = x["rays_pred"].grad
    terms = mesh.average_scalars({k: v.detach() for k, v in terms.items()},
                                 group)
    return {k: float(v) for k, v in terms.items()}, grads


def _rank_losses(rank, world, device, inputs, out):
    mine = _rows(inputs, rank)
    vals, grads = _loss_and_grads(mine, mesh.batch_group())
    local, _ = _loss_and_grads(mine, None)
    torch.save({"global": vals, "grads": grads, "local": local},
               Path(out) / f"loss{rank}.pt")


def _jax_terms(inputs):
    import jax
    import jax.numpy as jnp

    from rcmvsnet_tpu.losses.aug import aug_loss_multi_stage
    from rcmvsnet_tpu.losses.rays import (abs_error, acc_threshold,
                                          img2mse, sl1_loss)
    from rcmvsnet_tpu.losses.supervised import (abs_depth_error_metric,
                                                cas_mvsnet_loss,
                                                thres_metric)
    from rcmvsnet_tpu.losses.unsup import unsup_loss_multi_stage
    x = jax.tree_util.tree_map(jnp.asarray, inputs)

    def terms(est, rays_pred):
        outs = {k: {"depth": v} for k, v in est.items()}
        ray_mask = x["rays_gt"] > 0
        m3 = x["mask"]["stage3"] > 0.5
        return {
            "unsup": unsup_loss_multi_stage(outs, x["center_imgs"],
                                            x["proj"])[0],
            "aug": aug_loss_multi_stage(outs, x["pseudo"],
                                        x["filter_mask"])[0],
            "sl1": sl1_loss(rays_pred, x["rays_gt"], ray_mask),
            "img2mse": img2mse(x["rgb"], x["rgb_gt"]),
            "abs_error": abs_error(rays_pred, x["rays_gt"], ray_mask),
            "acc_2mm": acc_threshold(rays_pred, x["rays_gt"], ray_mask, 2.0),
            "cas": cas_mvsnet_loss(outs, x["gt"], x["mask"])[0],
            "thres2mm": thres_metric(est["stage3"], x["gt"]["stage3"], m3,
                                     2.0),
            "abs_depth": abs_depth_error_metric(est["stage3"],
                                                x["gt"]["stage3"], m3)}

    def total(e, r):
        t = terms(e, r)
        return sum(t[k] for k in ("unsup", "aug", "sl1", "img2mse",
                                  "cas")), t

    (_, vals), (ge, gr) = jax.jit(jax.value_and_grad(
        total, argnums=(0, 1), has_aux=True))(x["est"], x["rays_pred"])
    vals = {k: float(v) for k, v in vals.items()}
    grads = {k: np.asarray(v) for k, v in ge.items()}
    grads["rays"] = np.asarray(gr)
    return vals, grads


def test_global_loss_terms_match_jax_at_b2(tmp_path):
    inputs = _loss_inputs()
    # the masked terms' counts differ between the two samples
    for k in ("stage1", "stage2", "stage3"):
        assert inputs["mask"][k][0].sum() != inputs["mask"][k][1].sum()
    assert (inputs["rays_gt"][0] > 0).sum() != (inputs["rays_gt"][1] > 0
                                                 ).sum()
    _spawn(_rank_losses, inputs, str(tmp_path))
    ranks = [torch.load(tmp_path / f"loss{r}.pt") for r in range(WORLD)]
    want, want_grads = _jax_terms(inputs)
    _, port_grads = _loss_and_grads(inputs, None)
    for k, v in want.items():
        for r in ranks:
            np.testing.assert_allclose(r["global"][k], v, rtol=1e-6,
                                       atol=1e-9, err_msg=k)
    for k, g in want_grads.items():
        got = torch.cat([r["grads"][k] for r in ranks]).numpy() / WORLD
        one = port_grads[k].numpy()
        assert np.abs(got - one).max() <= 1e-6 * np.abs(one).max(), k
        assert np.abs(got - g).max() <= 1e-5 * np.abs(g).max(), k
    # per-rank masked means, averaged over the ranks, are not JAX's
    for k in MASKED:
        per_rank = np.mean([r["local"][k] for r in ranks])
        assert abs(per_rank - want[k]) > 1e-6 * abs(want[k]), k


# ---------------------------------------------------------------- step ----

COMPONENTS = ("reconstr_loss", "ssim_loss", "smooth_loss", "depth_loss")


def _golden_state_dicts():
    from rcmvsnet_tpu_torch.weights import ASSET, load_state_dict
    return load_state_dict(ASSET)


def _step_inputs():
    from rcmvsnet_tpu_torch.train.step import draw_step
    batch = make_synthetic_batch(B=WORLD, V=V, H=SH, W=SW, ndepth=32,
                                 seed=3)
    draws = draw_step(torch.Generator().manual_seed(4), CFG, WORLD, SH, SW)
    return batch, draws


def _step(batch, draws, group, device="cpu", one_rank=False):
    """One plain-path train step from the golden backbone (one_rank: its
    BatchNorms the cross-rank layer's in this one process); returns
    (metrics, grads, params, buffers) as CPU tensors by name."""
    from rcmvsnet_tpu_torch.parallel.sync_bn import convert
    from rcmvsnet_tpu_torch.train.state import create_train_state
    from rcmvsnet_tpu_torch.train.step import batch_to, make_train_step
    state = create_train_state(CFG, V, 100, device, seed=2,
                               state_dicts=(_golden_state_dicts(), None),
                               group=group)
    if one_rank:
        convert(state.cascade, None, one_rank=True)
        convert(state.render, None, one_rank=True)
    metrics = make_train_step(CFG, plain=True, group=group)(
        state, batch_to(batch, device), draws)
    named = {f"render.{k}": p for k, p in state.render.named_parameters()}
    named.update(dict(state.cascade.named_parameters()))
    bufs = {f"render.{k}": b for k, b in state.render.named_buffers()}
    bufs.update(dict(state.cascade.named_buffers()))
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.grad.detach().cpu() for k, p in named.items()},
            {k: p.detach().cpu() for k, p in named.items()},
            {k: b.detach().cpu() for k, b in bufs.items()})


def _rank_step(rank, world, device, batch, draws, out):
    res = _step(_rows(batch, rank), draws, mesh.batch_group(), device)
    torch.save(res, Path(out) / f"step{rank}.pt")


def test_two_rank_step_equals_single_process_b2(tmp_path):
    batch, draws = _step_inputs()
    _spawn(_rank_step, batch, draws, str(tmp_path))
    ranks = [torch.load(tmp_path / f"step{r}.pt") for r in range(WORLD)]
    m1, g1, p1, b1 = _step(batch, draws, None, one_rank=True)
    m_pt = _step(batch, draws, None)[0]
    for k in ("loss", "repr_loss", "aug_loss", "img_loss", "ray_depth_loss"):
        for r in ranks:
            np.testing.assert_allclose(r[0][k], m_pt[k], rtol=1e-5,
                                       err_msg=f"{k} vs PyTorch's BN")
    largest = max(float(v.abs().max()) for v in g1.values())
    for r in ranks:
        m, g, p, b = r
        assert set(m) == set(m1)
        for k, v in m1.items():
            rtol = 1e-3 if k.startswith(COMPONENTS) else 1e-5
            np.testing.assert_allclose(m[k], v, rtol=rtol, atol=1e-7,
                                       err_msg=k)
        for model in ("render.", ""):
            names = [n for n in g1 if n.startswith("render.") ==
                     (model == "render.")]
            scale = max(float(g1[n].abs().max()) for n in names)
            for n in names:
                err = float((g[n] - g1[n]).abs().max())
                assert err <= 1e-5 * largest, (n, err, largest)
                assert err <= 1e-4 * scale, (n, err, scale)
        for k, v in b1.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(b[k].numpy(), v.numpy(),
                                           rtol=1e-5, atol=1e-5, err_msg=k)
    # every rank applied the same update: parameters equal in every bit
    for k, v in ranks[0][2].items():
        assert torch.equal(v, ranks[1][2][k]), k
    for k, v in ranks[0][3].items():
        assert torch.equal(v, ranks[1][3][k]), k
    assert ranks[0][0] == ranks[1][0]


# ----------------------------------------------------------------- CLI ----

TRAIN_ARGS = ["rcmvsnet_tpu_torch.cli.train", "--trainpath", "synthetic",
              "--device", "cpu", "--num_view", "2", "--numdepth", "16",
              "--ndepths", "8,8,8", "--n_rays", "32", "--n_samples", "8",
              "--max_steps", "2", "--summary_freq", "1"]


@pytest.fixture(scope="module")
def dp_logdir(tmp_path_factory):
    """A 2-rank train CLI run of one epoch: (logdir, stdout)."""
    logdir = tmp_path_factory.mktemp("dp") / "log"
    out = _run_cli(TRAIN_ARGS + ["--epochs", "1", "--n_devices", "2",
                                 "--logdir", str(logdir)], REPO)
    return logdir, out


def test_train_cli_two_ranks_rank0_writes(dp_logdir):
    logdir, out = dp_logdir
    assert out.count("mesh: 2 devices / 2 process(es), global batch 2") == 1
    steps = [line for line in out.splitlines()
             if line.startswith("epoch 0 step")]
    assert len(steps) == 2, out
    assert out.count("epoch 0 val:") == 1
    names = sorted(p.name for p in logdir.iterdir())
    assert [n for n in names if n.endswith(".ckpt")] == [
        "model_000000_cas.ckpt", "model_000000_nerf.ckpt"]
    recs = [json.loads(line) for line in
            (logdir / "scalars.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if r["mode"] == "train"] == [1, 2]
    assert [r["mode"] for r in recs].count("fulltest") == 1
    assert all(np.isfinite(r["loss"]) for r in recs if r["mode"] == "train")


def _rank_resume(rank, world, device, logdirs, out):
    from rcmvsnet_tpu_torch.cli import train as train_cli
    args = train_cli.parse_args(TRAIN_ARGS[1:] + [
        "--epochs", "2", "--logdir", logdirs[rank]])
    config = train_cli.config_from_args(args)
    config, train_ds, val_ds = train_cli.build_datasets(config, world)
    try:
        r = train_cli.fit(config, train_ds, val_ds, device, resume=True,
                          max_steps=1, group=mesh.batch_group())
        msg = f"ok {r['start_epoch']} {r['train_steps']}"
    except SystemExit as e:
        msg = f"refused {e}"
    Path(out, f"resume{rank}.txt").write_text(msg)


def test_train_resume_refuses_inconsistent_ranks(dp_logdir, tmp_path):
    logdir, _ = dp_logdir
    dirs = [tmp_path / f"rank{r}" for r in range(WORLD)]
    for d in dirs:
        shutil.copytree(logdir, d)
    _spawn(_rank_resume, [str(d) for d in dirs], str(tmp_path))
    for r in range(WORLD):
        assert (tmp_path / f"resume{r}.txt").read_text() == "ok 1 1"
    # rank 1's checkpoint altered: both ranks refuse
    dirs = [tmp_path / f"bad{r}" for r in range(WORLD)]
    for d in dirs:
        shutil.copytree(logdir, d)
    cas = dirs[1] / "model_000000_cas.ckpt"
    ck = torch.load(cas)
    ck["model"]["feature.conv0.0.conv.weight"] += 0.01
    torch.save(ck, cas)
    _spawn(_rank_resume, [str(d) for d in dirs], str(tmp_path))
    for r in range(WORLD):
        msg = (tmp_path / f"resume{r}.txt").read_text()
        assert msg.startswith("refused") and "inconsistent" in msg, msg


def test_eval_dtu_two_ranks_writes_the_one_rank_files(tmp_path):
    from rcmvsnet_tpu_torch.data.synthetic import write_synthetic_scan
    from rcmvsnet_tpu_torch.weights import ASSET
    write_synthetic_scan(tmp_path / "data", H=64, W=96, V=3)
    common = ["rcmvsnet_tpu_torch.cli.eval_dtu", "--testpath",
              str(tmp_path / "data"), "--testlist", "scan1", "--loadckpt",
              str(ASSET), "--num_view", "3", "--numdepth", "64", "--max_h",
              "64", "--max_w", "96", "--prob_thres", "0.0",
              "--num_consistency", "1", "--num_worker", "1", "--device",
              "cpu"]
    _run_cli(common + ["--outdir", str(tmp_path / "one")], REPO)
    _run_cli(common + ["--outdir", str(tmp_path / "two"), "--n_devices",
                       "2"], REPO)
    files = sorted(p.relative_to(tmp_path / "one") for p in
                   (tmp_path / "one").rglob("*.pfm"))
    assert len(files) == 6                     # depth + confidence, 3 views
    for f in files:
        assert (tmp_path / "one" / f).read_bytes() == \
            (tmp_path / "two" / f).read_bytes(), f
    assert (tmp_path / "two" / "mvsnet001_l3.ply").exists()
