"""The slice as a whole: the PyTorch port's CascadeMVSNet eval against the
JAX package's, on the CPU, with the golden backbone through the weight
bridge; and the port through the committed end-to-end quality golden
(depth → fusion → DTU metric, tests/golden/e2e_quality.json)."""
import json
import sys
from pathlib import Path

import flax.serialization
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcmvsnet_tpu.config import Config
from rcmvsnet_tpu.data.synthetic import make_synthetic_views
from rcmvsnet_tpu.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from rcmvsnet_tpu.train.state import make_models
from rcmvsnet_tpu_torch.models.cascade import CascadeMVSNet, infer_views
from rcmvsnet_tpu_torch.weights import ASSET, load_state_dict

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
GOLDEN_JSON = REPO / "tests" / "golden" / "e2e_quality.json"
GOLDEN_CKPT = REPO / "tests" / "golden" / "backbone_synth.msgpack"


@pytest.fixture(scope="module")
def port_model():
    model = CascadeMVSNet()
    model.load_state_dict(load_state_dict(ASSET), strict=True)
    return model.eval()


def _sample(H=64, W=96, V=3, ndepth=192, seed=5):
    s = make_synthetic_views(H=H, W=W, V=V, seed=seed, baseline=8.0)
    imgs = ((s["images"] - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
    proj = np.zeros((V, 2, 4, 4), np.float32)
    for v in range(V):
        proj[v, 0] = s["extrinsics"][v]
        proj[v, 1, :3, :3] = s["intrinsics"]
        proj[v, 1, :2] /= 4.0
    pm = {"stage1": proj, "stage2": proj.copy(), "stage3": proj.copy()}
    pm["stage2"][:, 1, :2] *= 2
    pm["stage3"][:, 1, :2] *= 4
    dv = np.linspace(s["depth_min"], s["depth_max"], ndepth,
                     dtype=np.float32)
    return {"imgs": imgs, "proj_matrices": pm, "depth_values": dv}


def test_cascade_matches_jax(port_model):
    """64×96, V=3, 48/32/8 planes: depth max relative difference ≤ 1e-4
    at every stage; confidence |Δ| ≤ 1e-4 on ≥ 99.9% of pixels (its index
    is a truncation, which may flip where Σp·d sits on an integer)."""
    s = _sample()
    blob = flax.serialization.msgpack_restore(GOLDEN_CKPT.read_bytes())
    cascade, _ = make_models(Config())
    want = cascade.apply(
        {"params": blob["params"], "batch_stats": blob["batch_stats"]},
        jnp.asarray(s["imgs"])[None],
        {k: jnp.asarray(v)[None] for k, v in s["proj_matrices"].items()},
        jnp.asarray(s["depth_values"])[None], train=False)
    T = lambda a: torch.from_numpy(a)[None]
    with torch.no_grad():
        got = port_model(T(s["imgs"]),
                         {k: T(v) for k, v in s["proj_matrices"].items()},
                         T(s["depth_values"]))
    for stage in ("stage1", "stage2", "stage3"):
        dj = np.asarray(want[stage]["depth"])
        dt = got[stage]["depth"].numpy()
        assert dt.shape == dj.shape
        assert np.max(np.abs(dt - dj) / np.abs(dj)) <= 1e-4, stage
        cj = np.asarray(want[stage]["photometric_confidence"])
        ct = got[stage]["photometric_confidence"].numpy()
        assert np.mean(np.abs(ct - cj) <= 1e-4) >= 0.999, stage
    np.testing.assert_array_equal(got["depth"].numpy(),
                                  got["stage3"]["depth"].numpy())


def test_e2e_quality_matches_golden(port_model, tmp_path):
    """The port through the JAX package's golden pipeline, pinned with the
    tolerances of tests/test_e2e_quality.py."""
    sys.path.insert(0, str(REPO / "scripts"))
    import train_synth_golden as tsg

    ds, scene = tsg.build_samples(str(tmp_path / "scan"))

    def forward(imgs, projs, dv):
        sample = {"imgs": np.asarray(imgs)[0],
                  "proj_matrices": {k: np.asarray(v)[0]
                                    for k, v in projs.items()},
                  "depth_values": np.asarray(dv)[0]}
        depth, conf = infer_views(port_model, [sample], "cpu")[0]
        return {"depth": depth[None], "photometric_confidence": conf[None]}

    golden = json.loads(GOLDEN_JSON.read_text())
    metrics = tsg.run_quality(forward=forward, ds=ds, scene=scene)
    assert metrics["n_fused_raw"] > 50_000
    assert metrics["acc_mean"] < 1.0, metrics
    assert metrics["comp_mean"] < 2.0, metrics
    np.testing.assert_allclose(metrics["acc_mean"], golden["acc_mean"],
                               rtol=0.15, atol=0.02)
    np.testing.assert_allclose(metrics["comp_mean"], golden["comp_mean"],
                               rtol=0.15, atol=0.05)
    np.testing.assert_allclose(metrics["acc_median"], golden["acc_median"],
                               rtol=0.15, atol=0.02)
    assert abs(metrics["n_data"] - golden["n_data"]) < 0.05 * golden["n_data"]
