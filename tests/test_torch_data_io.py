"""The port's file and resize layer (``soccdpt_torch/data/image_io.py``),
its calib reader, its host library (``soccdpt_torch/native.py``) and its
import hygiene, held to the libraries the JAX package uses: cv2, pandas,
PyYAML and ``soccdpt_tpu.native``.

Tolerances, with their reasons:
* PNG files, ``INTER_LINEAR`` and ``INTER_NEAREST`` resizes of uint8,
  ``INTER_LINEAR`` of one-channel float32, ``COLOR_BGR2GRAY``, the CSV
  and YAML readers, the colour tables and the voxelizer: exact;
* ``INTER_LINEAR`` of float32 with three channels: 4e-5 on 0..255
  values (two units in the last place: cv2 rounds some pixels' products
  apart from its multiply-adds);
* ``INTER_CUBIC`` of float32: ``CUBIC_ATOL`` = 1.5e-4 on 0..255 values at
  the shapes the data layer resizes (a 1080p frame to a net input, a
  fixture frame to 1080p), where the measured worst is 9.2e-5 (3.1e-5 on
  the downscales): cv2's weights and sums round apart from these; the
  bound is 6e-7 of the value range;
* the host library against its plain versions and the JAX binding:
  exact.
"""
import re
from pathlib import Path

import cv2
import numpy as np
import pandas as pd
import pytest
import yaml

from soccdpt_tpu import native as jnative
from soccdpt_tpu.core.config import CameraConfig as JaxCamera

from soccdpt_torch import native
from soccdpt_torch.core.config import CameraConfig
from soccdpt_torch.data import image_io as io

CUBIC_ATOL = 1.5e-4
FILTERS = range(5)  # None, Sub, Up, Average, Paeth


def _images():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:61, 0:83]
    smooth = np.stack([(xx + yy) % 256, (2 * xx) % 256, (3 * yy) % 256], -1).astype(np.uint8)
    return {
        "bgr8": rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
        "grey8": rng.integers(0, 256, (37, 53), dtype=np.uint8),
        "grey16": rng.integers(0, 65536, (37, 53), dtype=np.uint16),
        "bgr16": rng.integers(0, 65536, (29, 31, 3), dtype=np.uint16),
        "bgra8": rng.integers(0, 256, (21, 19, 4), dtype=np.uint8),
        "smooth": smooth,  # gradients: libpng's adaptive filter picks several types
    }


IMAGES = _images()


@pytest.mark.parametrize("name", sorted(IMAGES))
@pytest.mark.parametrize("flags", [cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE])
def test_imread_equals_cv2_on_files_cv2_wrote(tmp_path, name, flags):
    img = IMAGES[name]
    path = str(tmp_path / f"{name}.png")
    assert cv2.imwrite(path, img)
    if flags == cv2.IMREAD_GRAYSCALE and img.ndim == 3:
        with pytest.raises(ValueError):  # colour -> grey on read is not ported
            io.imread(path, flags)
        return
    want = cv2.imread(path, flags)
    got = io.imread(path, flags)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(IMAGES))
@pytest.mark.parametrize("ftype", FILTERS)
def test_cv2_reads_back_what_imwrite_wrote(tmp_path, name, ftype):
    img = IMAGES[name]
    path = str(tmp_path / f"{name}_{ftype}.png")
    io.imwrite(path, img, filter_type=ftype)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(io.imread(path, io.IMREAD_UNCHANGED), img)


def test_every_filter_type_round_trips_row_by_row(tmp_path):
    """One file whose rows cycle through all five types, read by cv2, by
    the C++ unfilter and by the plain one."""
    img = IMAGES["smooth"]
    types = [t % 5 for t in range(img.shape[0])]
    data = io.encode_png(img[..., ::-1], filter_type=types)
    path = tmp_path / "mixed.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(cv2.imread(str(path)), img)
    np.testing.assert_array_equal(io.imread(str(path)), img)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6])
def test_cpp_and_plain_unfilter_agree(bpp):
    assert native.AVAILABLE, native.build_error()
    rng = np.random.default_rng(bpp)
    height, rowbytes = 23, 7 * bpp
    raw = rng.integers(0, 256, (height, rowbytes + 1), dtype=np.uint8)
    raw[:, 0] = rng.integers(0, 5, height)
    raw[0, 0] = 4  # Paeth on the first row: no row above
    got = native.png_unfilter(raw.tobytes(), height, rowbytes, bpp)
    want = native.png_unfilter_plain(raw.tobytes(), height, rowbytes, bpp)
    np.testing.assert_array_equal(got, want)
    raw[5, 0] = 9
    with pytest.raises(ValueError, match="row 5"):
        native.png_unfilter(raw.tobytes(), height, rowbytes, bpp)
    with pytest.raises(ValueError, match="row 5"):
        native.png_unfilter_plain(raw.tobytes(), height, rowbytes, bpp)


CV2_FILTERS = {
    "none": cv2.IMWRITE_PNG_FILTER_NONE,
    "sub": cv2.IMWRITE_PNG_FILTER_SUB,  # cv2's default
    "up": cv2.IMWRITE_PNG_FILTER_UP,
    "avg": cv2.IMWRITE_PNG_FILTER_AVG,
    "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
    "all": cv2.IMWRITE_PNG_ALL_FILTERS,  # libpng picks a type per row
}


@pytest.mark.parametrize("cv2_filter", sorted(CV2_FILTERS))
def test_files_cv2_wrote_with_each_filter(tmp_path, cv2_filter):
    """cv2 writes Sub rows unless told otherwise; make it write each type,
    and the adaptive mix, and read what it wrote row for row."""
    import zlib

    path = str(tmp_path / "s.png")
    img = IMAGES["smooth"]
    cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, CV2_FILTERS[cv2_filter]])
    data = Path(path).read_bytes()
    idat = b"".join(
        data[m.end():m.end() + int.from_bytes(data[m.start() - 4:m.start()], "big")]
        for m in re.finditer(b"IDAT", data)
    )
    h, w = img.shape[:2]
    types = set(np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 3 * w + 1)[:, 0].tolist())
    assert types <= set(FILTERS)
    if cv2_filter == "all":
        assert len(types) > 1, types
    np.testing.assert_array_equal(io.imread(path), img)


# --- resize -------------------------------------------------------------------

U8_CASES = [
    ((96, 128, 3), (1920, 1080)),  # a fixture frame to 1080p (BDDDepthSegmentation)
    ((96, 128), (1920, 1080)),
    ((1080, 1920, 3), (256, 256)),
    ((33, 17, 3), (13, 9)),
    ((5, 7), (200, 100)),
    ((40, 60, 3), (60, 40)),
]


@pytest.mark.parametrize("shape,dsize", U8_CASES)
def test_uint8_bilinear_is_cv2_bit_for_bit(shape, dsize):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(io.resize(img, dsize), cv2.resize(img, dsize))
    np.testing.assert_array_equal(
        io.resize(img, dsize, io.INTER_NEAREST), cv2.resize(img, dsize, interpolation=cv2.INTER_NEAREST)
    )


@pytest.mark.parametrize("shape,dsize", U8_CASES)
def test_float_bilinear_and_bicubic_against_cv2(shape, dsize):
    img = np.random.default_rng(2).integers(0, 256, shape).astype(np.float32)
    lin, want = io.resize(img, dsize), cv2.resize(img, dsize)
    if img.ndim == 2:
        np.testing.assert_array_equal(lin, want)
    else:
        np.testing.assert_allclose(lin, want, rtol=0, atol=4e-5)
    cub = io.resize(img, dsize, io.INTER_CUBIC)
    want = cv2.resize(img, dsize, interpolation=cv2.INTER_CUBIC)
    if shape[0] > dsize[1] * 8:  # downscales past 8x are on no path of the data layer
        return
    np.testing.assert_allclose(cub, want, rtol=0, atol=CUBIC_ATOL)


def test_same_size_resize_is_a_copy():
    img = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    out = io.resize(img, (4, 2))
    np.testing.assert_array_equal(out, img)
    assert out is not img and not np.shares_memory(out, img)


def test_bgr_to_gray_is_cv2s():
    img = np.random.default_rng(3).integers(0, 256, (64, 80, 3), dtype=np.uint8)
    np.testing.assert_array_equal(io.bgr_to_gray(img), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))


# --- calib YAML and CSV ------------------------------------------------------------

CAMERA = dict(fx=115.2, fy=1e-5, cx=64.0, cy=48.0, width=128, height=96, k1=1e20, k2=-3.25e-7)


def test_calib_yaml_both_ways(tmp_path):
    JaxCamera(**CAMERA).to_yaml(str(tmp_path / "jax.yaml"))
    CameraConfig(**CAMERA).to_yaml(str(tmp_path / "port.yaml"))
    assert (tmp_path / "jax.yaml").read_text() == (tmp_path / "port.yaml").read_text()
    assert CameraConfig.from_yaml(str(tmp_path / "jax.yaml")) == CameraConfig(**CAMERA)
    assert JaxCamera.from_yaml(str(tmp_path / "port.yaml")) == JaxCamera(**CAMERA)
    assert yaml.safe_load((tmp_path / "port.yaml").read_text())["Camera.fy"] == 1e-5


def test_calib_yaml_with_the_opencv_header(tmp_path):
    path = tmp_path / "calib.yaml"
    path.write_text(
        "%YAML:1.0\n---\n# pocoX3\nCamera.fx: 1446.5\nCamera.fy: 1447\n"
        "Camera.cx: 960.\nCamera.cy: 540.0\nCamera.width: 1920\nCamera.height: 1080\n"
        "Camera.k1: -0.12\n"
    )
    cam = CameraConfig.from_yaml(str(path))
    assert cam == CameraConfig(fx=1446.5, fy=1447.0, cx=960.0, cy=540.0, width=1920,
                               height=1080, k1=-0.12)
    assert isinstance(cam.width, int) and isinstance(cam.fy, float)


def test_csv_columns_equal_pandas(tmp_path):
    index = tmp_path / "seq.csv"
    index.write_text("index,Timestamp\n0,1000000000001\n1,1000000000034\n2,1000000000067\n")
    assert io.read_csv_column(str(index), 1) == [
        str(v) for v in pd.read_csv(index).iloc[:, 1].tolist()
    ]
    traj = tmp_path / "seq_traj.csv"
    rng = np.random.default_rng(4)
    with open(traj, "w") as fh:
        fh.write("Timestamp,x,rot\n")
        for i in range(4):
            r = rng.standard_normal((3, 3)).astype(np.float32)
            fh.write(f'{1000 + 33 * i},{i * 0.5},"{np.array2string(r)}"\n')  # rows span lines
    cols = io.read_csv_columns(str(traj))
    want = pd.read_csv(traj)
    assert list(cols) == list(want.columns)
    for name in want.columns:
        assert cols[name] == [str(v) for v in want[name].tolist()], name


# --- the host library ---------------------------------------------------------------


def _jax_plain(fn_name, *args):
    """The JAX module's numpy fallback, its library hidden."""
    saved_lib, saved_loader = jnative._lib, jnative._try_load
    jnative._lib, jnative._try_load = None, lambda: None
    try:
        return getattr(jnative, fn_name)(*args)
    finally:
        jnative._lib, jnative._try_load = saved_lib, saved_loader


def _native_cases():
    rng = np.random.default_rng(5)
    colors = np.array([(0, 0, 0), (0, 0, 142), (220, 20, 60)], np.uint8)
    seg = colors[rng.integers(0, 3, (37, 53))]
    seg[0, 0] = (7, 7, 7)
    pts = (rng.random((5000, 3)).astype(np.float32) * 1.2 - 0.1) * 8.0
    pts[:20] = np.inf
    sem = rng.integers(-1, 4, 5000).astype(np.int32)
    return {
        "rgb_to_class": (seg, colors),
        "rgb_to_bool_masks": (seg, colors),
        "voxelize_points": (pts, sem, (8.0, 8.0, 8.0), (16, 16, 8), 3),
    }


NATIVE_CASES = _native_cases()


@pytest.mark.parametrize("fn_name", sorted(NATIVE_CASES))
def test_native_equals_the_jax_binding_on_both_paths(fn_name):
    assert native.AVAILABLE, native.build_error()
    args = NATIVE_CASES[fn_name]
    port_lib = getattr(native, fn_name)(*args)
    port_plain = getattr(native, fn_name + "_plain")(*args)
    np.testing.assert_array_equal(port_plain, _jax_plain(fn_name, *args))
    np.testing.assert_array_equal(port_lib, port_plain)
    if jnative.available():
        np.testing.assert_array_equal(port_lib, getattr(jnative, fn_name)(*args))


def test_voxelizer_drops_index_zero_on_every_axis():
    """The GT quirk kept from the reference: 0 < ijk < grid."""
    pts = np.array([[0.1, 5.0, 5.0], [5.0, 0.1, 5.0], [5.0, 5.0, 0.1], [5.0, 5.0, 5.0]], np.float32)
    sem = np.zeros(4, np.int32)
    for fn in (native.voxelize_points, native.voxelize_points_plain):
        grid = fn(pts, sem, (8.0, 8.0, 8.0), (8, 8, 8), 1)
        assert grid.sum() == 1 and grid[5, 5, 5, 0] == 1


def test_the_library_builds_outside_the_jax_packages_directory():
    assert native.AVAILABLE, native.build_error()
    lib = Path(native.load()._name)
    assert lib.parent == native.BUILD_DIR and lib.parent.name == "soccdpt_torch_native"
    assert native.load().soccdpt_native_version() == 1


# --- import hygiene -------------------------------------------------------------------

FORBIDDEN = ("jax", "flax", "optax", "orbax", "soccdpt_tpu", "cv2", "pandas", "yaml", "PIL")


def test_the_port_imports_none_of_the_jax_package_or_its_data_libraries():
    root = Path(__file__).resolve().parents[1]
    pattern = re.compile(r"^\s*(?:import|from)\s+([A-Za-z_][\w.]*)", re.M)
    found = []
    for path in sorted((root / "soccdpt_torch").rglob("*.py")) + [root / "chip_smoke.py"]:
        for mod in pattern.findall(path.read_text()):
            if mod.split(".")[0] in FORBIDDEN:
                found.append(f"{path.relative_to(root)}: {mod}")
    assert not found, found
