"""The port's copies of the DTU train / val datasets and the data loader
against the JAX package's, on a temporary DTU train tree in the
reference's layout: one scan, 3 views (each the others' source), light 0's
512×640 `Rectified` PNGs, 1200×1600 `Depths_raw` pfm depth and
`depth_visual` PNG (the size `transforms.prepare_img` crops from).

Items, loader batches and `epoch_indices` must be equal to the JAX
package's (`np.array_equal` on every key, the same seed): the train items
carry seeded color jitter and gamma, so equal items also mean the same
random draws in the same order. Only light 0 is on disk, so the loaders
run over a light-0 view of each dataset."""
import cv2
import numpy as np
import pytest

from rcmvsnet_tpu.data import dtu_train as jtrain
from rcmvsnet_tpu.data import dtu_val as jval
from rcmvsnet_tpu.data import loader as jloader
from rcmvsnet_tpu_torch.core.io import (save_pfm, write_cam_file,
                                         write_pair_file)
from rcmvsnet_tpu_torch.data import dtu_train as ttrain
from rcmvsnet_tpu_torch.data import dtu_val as tval
from rcmvsnet_tpu_torch.data import loader as tloader

V = 3


@pytest.fixture(scope="module")
def dtu_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("dtu")
    rs = np.random.RandomState(0)
    cams = root / "Cameras" / "train"
    cams.mkdir(parents=True)
    rect = root / "Rectified" / "scan1_train"
    rect.mkdir(parents=True)
    depths = root / "Depths_raw" / "scan1"
    depths.mkdir(parents=True)
    K = np.array([[180.0, 0, 80], [0, 180.0, 64], [0, 0, 1]], np.float32)
    for v in range(V):
        E = np.eye(4, dtype=np.float32)
        E[0, 3] = -6.0 * v
        write_cam_file(cams / f"{v:08d}_cam.txt", E, K, [425.0, 2.5])
        cv2.imwrite(str(rect / f"rect_{v + 1:03d}_0_r5000.png"),
                    rs.randint(0, 256, (512, 640, 3), np.uint8))
        save_pfm(depths / f"depth_map_{v:04d}.pfm",
                 (600 + 50 * rs.rand(1200, 1600)).astype(np.float32))
        cv2.imwrite(str(depths / f"depth_visual_{v:04d}.png"),
                    rs.randint(0, 30, (1200, 1600), np.uint8))
    write_pair_file(root / "Cameras" / "pair.txt",
                    [(v, [u for u in range(V) if u != v]) for v in range(V)])
    return root


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)


class _Light0:
    """The light-0 items of a dataset (metas run scan, ref, light)."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds) // 7

    def __getitem__(self, i):
        return self.ds[7 * i]


def _train_sets(root):
    kw = dict(nviews=V, ndepths=32, interval_scale=1.06, seed=3)
    return (ttrain.DTUTrainDataset(root, ["scan1"], **kw),
            jtrain.DTUTrainDataset(root, ["scan1"], **kw))


def test_dtu_train_items_match_jax(dtu_tree):
    a, b = _train_sets(dtu_tree)
    assert len(a) == len(b) == V * 7 and a.metas == b.metas
    for i in (0, 7, 14):
        ia, ib = a[i], b[i]
        _equal_trees(ia, ib)
    assert ia["imgs"].shape == (V, 512, 640, 3)
    assert ia["depths_h"].shape == (V, 512, 640)
    assert ia["depth"]["stage1"].shape == (128, 160)
    assert 0 < ia["mask"]["stage3"].mean() < 1
    _equal_trees(a.sample_cams_all(), b.sample_cams_all())


def test_dtu_val_items_match_jax(dtu_tree):
    kw = dict(nviews=V, ndepths=32, interval_scale=1.06)
    a = tval.DTUValDataset(dtu_tree, ["scan1"], **kw)
    b = jval.DTUValDataset(dtu_tree, ["scan1"], **kw)
    assert len(a) == len(b) == V * 7
    for i in (0, 14):
        _equal_trees(a[i], b[i])
    img = a[0]["imgs"]                 # raw [0, 1], not ImageNet-normalized
    assert img.min() >= 0 and img.max() <= 1


def test_loader_and_epoch_indices_match_jax(dtu_tree):
    for n, epoch, shuffle, seed, pi, pc, drop in [
            (21, 0, True, 1, 0, 1, True), (21, 3, True, 1, 0, 1, True),
            (7, 2, False, 0, 0, 1, False), (9, 1, True, 5, 1, 4, False),
            (9, 1, True, 5, 3, 4, True)]:
        np.testing.assert_array_equal(
            tloader.epoch_indices(n, epoch, shuffle, seed, pi, pc, drop),
            jloader.epoch_indices(n, epoch, shuffle, seed, pi, pc, drop))
    a, b = _train_sets(dtu_tree)
    loaders = [mod.DataLoader(_Light0(ds), 2, shuffle=True, seed=4,
                              drop_last=False)
               for mod, ds in ((tloader, a), (jloader, b))]
    assert len(loaders[0]) == len(loaders[1]) == 2
    for dl in loaders:
        dl.set_epoch(1)
    got = [list(dl) for dl in loaders]
    assert [x["imgs"].shape[0] for x in got[0]] == [2, 1]
    for x, y in zip(*got):
        _equal_trees(x, y)
