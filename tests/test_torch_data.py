"""The port's data layer against the JAX package's, on the CPU: BDD and IDD
samples on fixture trees written by either package, the GT occupancy
grids, the host transforms, splits and batch orders
(mirrors tests/test_data.py and tests/test_native.py).

Tolerances: every array of a sample is exact (the GT grids too), but the
network input ``image``, whose float32 bicubic resize is held to
``IMAGE_ATOL`` = 3e-4 on its -1..509 values (tests/test_torch_data_io.py's
1.5e-4 on 0..255 values, doubled by the normalisation).
"""
import numpy as np
import pytest

from soccdpt_tpu.data import bdd as jbdd
from soccdpt_tpu.data import idd as jidd
from soccdpt_tpu.data import loader as jloader
from soccdpt_tpu.data import synthetic as jsyn
from soccdpt_tpu.data import transforms as jtf

from soccdpt_torch.data import bdd, idd, loader, synthetic
from soccdpt_torch.data import transforms as tf
from soccdpt_torch.data.anue_labels import level1_to_class, level4_basics_to_class

IMAGE_ATOL = 3e-4
SEQUENCES = ("1000000000001", "1000000000002")
WRITERS = {"jax": jsyn, "port": synthetic}


@pytest.fixture(scope="module")
def bdd_trees(tmp_path_factory):
    """One BDD tree written by each package, same seed."""
    trees = {}
    for name, mod in WRITERS.items():
        base = tmp_path_factory.mktemp(f"bdd_{name}")
        mod.make_bdd_fixture(str(base), frames_per_seq=3)
        trees[name] = str(base)
    return trees


@pytest.fixture(scope="module")
def idd_trees(tmp_path_factory):
    trees = {}
    for name, mod in WRITERS.items():
        base = tmp_path_factory.mktemp(f"idd_{name}")
        mod.make_idd_fixture(str(base), level_id="level1Ids")
        trees[name] = str(base)
    return trees


def _assert_sample_equal(got, want, where):
    assert set(got) == set(want), where
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, (where, key)
        if key == "image":
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=IMAGE_ATOL, err_msg=where)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{where} {key}")


def test_both_writers_write_the_same_trees(bdd_trees, idd_trees):
    import cv2
    from pathlib import Path

    for trees in (bdd_trees, idd_trees):
        jax_files = sorted(p.relative_to(trees["jax"]) for p in Path(trees["jax"]).rglob("*.*"))
        port_files = sorted(p.relative_to(trees["port"]) for p in Path(trees["port"]).rglob("*.*"))
        assert jax_files == port_files and len(jax_files) > 10
        for rel in jax_files:
            a, b = Path(trees["jax"]) / rel, Path(trees["port"]) / rel
            if rel.suffix == ".png":
                np.testing.assert_array_equal(cv2.imread(str(a), -1), cv2.imread(str(b), -1), str(rel))
            else:
                assert a.read_text() == b.read_text(), rel


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("cls", ["BDDDepthSegmentation", "BDDOccupancy", "BDDDepth", "BDDSegmentation"])
def test_bdd_samples_equal_jax(bdd_trees, writer, cls):
    """Every sample, on the tree either package wrote: frames upsampled to
    1920x1080 (uint8 bilinear, seg colours blended at box edges), the
    transform to net size, and the GT grid from the host voxelizer."""
    base = bdd_trees[writer]
    jt, _, _ = jtf.load_transforms("dpt_swin2_test_64")
    pt, _, _ = tf.load_transforms("dpt_swin2_test_64")
    want = jbdd.get_bdd_dataset(getattr(jbdd, cls), jt, base, sequences=SEQUENCES)
    got = bdd.get_bdd_dataset(getattr(bdd, cls), pt, base, sequences=SEQUENCES)
    assert len(got) == len(want) == 6
    indices = range(len(want)) if cls in ("BDDDepthSegmentation", "BDDOccupancy") else (0, 5)
    for i in indices:
        _assert_sample_equal(got[i], want[i], f"{cls}[{i}] on the {writer} tree")


def test_occupancy_gt_at_camera_resolution_equals_jax(bdd_trees):
    """As the trainer reads it: frames at the calib camera's size, GT from
    the processor's points (rotation ``points @ R`` with ``transpose``,
    ``occupied = grid > threshold``, occupancy points ``>=``)."""
    base = bdd_trees["port"]
    jt, _, _ = jtf.load_transforms("dpt_swin2_test_64")
    pt, _, _ = tf.load_transforms("dpt_swin2_test_64")
    want = jbdd.get_bdd_dataset(jbdd.BDDOccupancy, jt, base, sequences=SEQUENCES[:1])
    got = bdd.get_bdd_dataset(bdd.BDDOccupancy, pt, base, sequences=SEQUENCES[:1])
    for ds in (want, got):
        cam = ds.datasets[0].seq.camera
        ds.datasets[0].target_size = (cam.width, cam.height)
    _assert_sample_equal(got[1], want[1], "BDDOccupancy at 128x96")
    frame_j = want.datasets[0].proc.process_frame(want.datasets[0].seq[2])
    frame_p = got.datasets[0].proc.process_frame(got.datasets[0].seq[2])
    for key in ("depth", "points", "occupancy_grid", "occupancy_points"):
        np.testing.assert_array_equal(frame_p[key], frame_j[key], err_msg=key)
    assert frame_p["occupancy_grid"].any()


def test_sequence_frames_and_trajectory_equal_jax(bdd_trees, tmp_path):
    import shutil

    seq_dir = tmp_path / SEQUENCES[0]
    shutil.copytree(f"{bdd_trees['port']}/{SEQUENCES[0]}", seq_dir)
    calib = f"{bdd_trees['port']}/calibration/pocoX3/calib.yaml"
    rng = np.random.default_rng(0)
    with open(seq_dir / f"{SEQUENCES[0]}_traj.csv", "w") as fh:
        fh.write("Timestamp,x,rot\n")
        for i in range(6):
            rot = np.array2string(rng.standard_normal((3, 3)).astype(np.float32))
            fh.write(f'{1000000000001 + 17 * i},{0.25 * i},"{rot}"\n')
    want = jbdd.BDDSequence(str(seq_dir), calib)
    got = bdd.BDDSequence(str(seq_dir), calib)
    assert len(got) == len(want) == 3 and got.camera.__dict__ == want.camera.__dict__
    for i in range(len(want)):
        a, b = want[i], got[i]
        assert a["timestamp"] == b["timestamp"]
        for key in ("rgb_frame", "seg_frame", "disparity_frame"):
            np.testing.assert_array_equal(b[key], a[key])
    rows_j = want.traj_between(1000000000010, 1000000000060)
    rows_p = got.traj_between(1000000000010, 1000000000060)
    np.testing.assert_array_equal(rows_p["Timestamp"], rows_j["Timestamp"].to_numpy())
    assert len(rows_p["rot"]) == len(rows_j) == 3
    for r_p, r_j in zip(rows_p["rot"], rows_j["rot"]):
        np.testing.assert_array_equal(r_p, r_j)
    assert rows_p["x"] == [str(v) for v in rows_j["x"]]


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("level", ["level1", "level4_basics"])
def test_idd_samples_equal_jax(idd_trees, writer, level):
    base = idd_trees[writer]
    level_2_class = {"level1": level1_to_class, "level4_basics": level4_basics_to_class}[level]
    jt, _, _ = jtf.load_transforms("dpt_swin2_test_64")
    pt, _, _ = tf.load_transforms("dpt_swin2_test_64")
    want = jidd.get_all_idd_datasets(jt, level_2_class=level_2_class, idd_dataset_path=base)
    got = idd.get_all_idd_datasets(pt, level_2_class=level_2_class, idd_dataset_path=base)
    for split_j, split_p in zip(want, got):
        assert len(split_p) == len(split_j) == 4
        for i in (0, 3):
            _assert_sample_equal(split_p[i], split_j[i], f"IDD {level} [{i}] on the {writer} tree")
    seg_only = idd.get_all_IDD_Segmentation_datasets(pt, level_2_class=level_2_class,
                                                     idd_dataset_path=base)[0]
    assert set(seg_only[0]) == {"image", "image_raw", "mask_seg", "seg"}


@pytest.mark.parametrize("model_type", ["dpt_swin2_tiny_256", "dpt_beit_large_384", "dpt_large_384",
                                        "dpt_swin2_test_64"])
@pytest.mark.parametrize("hw", [(96, 128), (1080, 1920), (480, 640)])
def test_transforms_equal_jax(model_type, hw):
    img = np.random.default_rng(1).integers(0, 256, (*hw, 3)).astype(np.float32)
    jt, jw, jh = jtf.load_transforms(model_type)
    pt, pw, ph = tf.load_transforms(model_type)
    assert (pw, ph) == (jw, jh)
    want = jt({"image": img.copy()})["image"]
    got = pt({"image": img.copy()})["image"]
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=IMAGE_ATOL)
    for args in [(1920, 1080, 384, 384, True, 32, m) for m in ("lower_bound", "upper_bound", "minimal")]:
        assert tf.compute_resize_shape(*args) == jtf.compute_resize_shape(*args)


def test_resize_transform_resizes_targets_nearest():
    sample = {"image": np.zeros((96, 128, 3), np.float32),
              "disparity": np.arange(96 * 128, dtype=np.float32).reshape(96, 128),
              "mask": np.arange(96 * 128).reshape(96, 128) % 3 == 0}
    want = jtf.Resize(64, 48, resize_target=True)({k: v.copy() for k, v in sample.items()})
    got = tf.Resize(64, 48, resize_target=True)({k: v.copy() for k, v in sample.items()})
    for key in ("disparity", "mask"):
        np.testing.assert_array_equal(got[key], want[key])


# --- splits, orders and feeders ---------------------------------------------------


class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if not 0 <= i < self.n:
            raise IndexError(i)
        return {"idx": np.asarray([i]), "x": np.full((2, 3), i, np.float32),
                "m": np.asarray([i % 2 == 0])}


@pytest.mark.parametrize("n,val_percent,pct", [(8, 0.25, 1.0), (37, 0.1, 0.5), (6, 0.34, 1.0)])
def test_splits_and_orders_equal_jax(n, val_percent, pct):
    tr_j, va_j = jloader.split_train_val(_Indices(n), val_percent, pct, seed=3)
    tr_p, va_p = loader.split_train_val(_Indices(n), val_percent, pct, seed=3)
    assert [tr_p[i]["idx"][0] for i in range(len(tr_p))] == [tr_j[i]["idx"][0] for i in range(len(tr_j))]
    assert [va_p[i]["idx"][0] for i in range(len(va_p))] == [va_j[i]["idx"][0] for i in range(len(va_j))]
    for kw in [dict(shuffle=True, seed=0, epoch=2), dict(shuffle=False),
               dict(shuffle=True, seed=1, epoch=0, drop_last=False),
               dict(shuffle=True, seed=0, epoch=1, process_index=1, process_count=3)]:
        want = [b["idx"].ravel().tolist() for b in jloader.iterate_batches(tr_j, 2, **kw)]
        got = [b["idx"].ravel().tolist() for b in loader.iterate_batches(tr_p, 2, **kw)]
        assert got == want, kw


def test_concat_dataset_and_discovery_equal_jax(bdd_trees):
    base = bdd_trees["port"]
    assert bdd.discover_sequences(base) == jbdd.discover_sequences(base) == SEQUENCES
    parts = [_Indices(3), _Indices(0), _Indices(2)]
    want, got = jbdd.ConcatDataset(parts), bdd.ConcatDataset(parts)
    assert len(got) == len(want) == 5
    for i in range(-5, 5):
        assert got[i]["idx"][0] == want[i]["idx"][0]
    for ds in (want, got):
        with pytest.raises(IndexError):
            ds[5]
