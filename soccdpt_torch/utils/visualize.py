"""Visualization artifacts (the port of ``soccdpt_tpu/utils/visualize.py``).

Reference equivalents: colormapped disparity + class-color segmentation
side-by-sides (reference utils/__init__.py:646-708, eval_SOccDPT.py:
175-244), height-colored point clouds (color_by_index,
utils/__init__.py:347-371), occupancy-grid point export.

The JAX package takes its colormaps from matplotlib and resizes and
writes with cv2; the machine that runs the port has neither. The two
colormaps it uses are kept here as data: 256 RGB rows each, matplotlib's
``colormaps["plasma"]`` and ``["viridis"]`` sampled at their 256 entries
and scaled to uint8 as the JAX package scales them, and looked up as
matplotlib looks up a float in ``[0, 1]`` (``floor(x * 256)``, 1.0 on the
last row, NaN black). Panels are resized with ``data/image_io.resize``
(``cv2.resize``'s bilinear on uint8, bit for bit) and written with
``data/image_io.imwrite``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..data import image_io

# uint8 RGB rows, hex, row i = matplotlib's colormap at entry i
_COLORMAPS_HEX = {
    "plasma": (
    "0c078610078713068915068a18068b1b068c1d068d1f058e21058f230590250591270592"
    "2905932b05942d04942f04953104963304973404983604983804993a049a3b039a3d039b"
    "3f039c40039c42039d44039e45039e47029f49029f4a02a04c02a14e02a14f02a25101a2"
    "5201a35401a35601a35701a45901a45a00a55c00a55e00a55f00a66100a66200a66400a7"
    "6500a76700a76800a76a00a76c00a86d00a86f00a87000a87200a87300a87500a87601a8"
    "7801a87901a87b02a87c02a77e03a77f03a78104a78204a78405a68506a68607a68807a5"
    "8908a58b09a48c0aa48e0ca48f0da3900ea3920fa29310a19511a19612a09713a099149f"
    "9a159e9b179e9d189d9e199c9f1a9ba01b9ba21c9aa31d99a41e98a51f97a72197a82296"
    "a92395aa2494ac2593ad2692ae2791af2890b02a8fb12b8fb22c8eb42d8db52e8cb62f8b"
    "b7308ab83289b93388ba3487bb3586bc3685bd3784be3883bf3982c03b81c13c80c23d80"
    "c33e7fc43f7ec5407dc6417cc7427bc8447ac94579ca4678cb4777cc4876cd4975ce4a75"
    "cf4b74d04d73d14e72d14f71d25070d3516fd4526ed5536dd6556dd7566cd7576bd8586a"
    "d95969da5a68db5b67dc5d66dc5e66dd5f65de6064df6163df6262e06461e16560e26660"
    "e3675fe3685ee46a5de56b5ce56c5be66d5ae76e5ae87059e87158e97257ea7356ea7455"
    "eb7654ec7754ec7853ed7952ed7b51ee7c50ef7d4fef7e4ef0804df0814df1824cf2844b"
    "f2854af38649f38748f48947f48a47f58b46f58d45f68e44f68f43f69142f79241f79341"
    "f89540f8963ff8983ef9993df99a3cfa9c3bfa9d3afa9f3afaa039fba238fba337fba436"
    "fca635fca735fca934fcaa33fcac32fcad31fdaf31fdb030fdb22ffdb32efdb52dfdb62d"
    "fdb82cfdb92bfdbb2bfdbc2afdbe29fdc029fdc128fdc328fdc427fdc626fcc726fcc926"
    "fccb25fccc25fcce25fbd024fbd124fbd324fad524fad624fad824f9d924f9db24f8dd24"
    "f8df24f7e024f7e225f6e425f6e525f5e726f5e926f4ea26f3ec26f3ee26f2f026f2f126"
    "f1f326f0f525f0f623eff821"
    ),
    "viridis": (
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163"
    "47126547146647156747166947186a48196b481a6c481c6e481d6f481e70482071482172"
    "482273482374472575472676472777472878472a79472b7a472c7b462d7c462f7c46307d"
    "46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c89"
    "3c4d8a3c4e8a3b508a3b518a3a528b3a538b39548b39558b38568b38578c37588c37598c"
    "365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d32628d32638d31648d31658d"
    "31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e"
    "277d8e277e8e267f8e26808e26818e25828e25838d24848d24858d24868d23878d23888d"
    "23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c20908c20918c1f928c1f938b"
    "1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a982"
    "24aa8225ab8126ac8127ad8028ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a"
    "32b57a33b67935b77836b87738b97639b9763bba753dbb743ebc7340bd7242be7144be70"
    "45bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d052"
    "79d1517cd24f7ed24e81d34c83d34b86d44988d5478bd5468dd64490d64392d74195d73f"
    "97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32addc30afdc2eb2dd2cb5dd2b"
    "b7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51e"
    "f6e61ff8e621fae622fde724"
    ),
}
_TABLES: Dict[str, np.ndarray] = {}


def _table(name: str) -> np.ndarray:
    if name not in _TABLES:
        if name not in _COLORMAPS_HEX:
            raise ValueError(f"colormap {name!r} is not kept here: {sorted(_COLORMAPS_HEX)}")
        _TABLES[name] = np.frombuffer(bytes.fromhex(_COLORMAPS_HEX[name]), np.uint8).reshape(256, 3)
    return _TABLES[name]


def _colormap(values01: np.ndarray, name: str = "plasma") -> np.ndarray:
    x = np.clip(values01, 0.0, 1.0)
    xa = x * np.asarray(256, x.dtype)
    xa[xa == 256] = 255
    bad = np.isnan(xa)
    rgb = _table(name)[np.where(bad, 0, xa).astype(np.int64)]
    rgb[bad] = 0
    return rgb


def colorize_disparity(disp: np.ndarray, cmap: str = "plasma") -> np.ndarray:
    """(H, W) -> (H, W, 3) uint8, min-max normalized (reference
    utils/__init__.py:649-655)."""
    lo, hi = float(np.min(disp)), float(np.max(disp))
    norm = (disp - lo) / (hi - lo) if hi > lo else np.zeros_like(disp)
    return _colormap(norm, cmap)


def color_segmentation(
    masks: np.ndarray, class_2_color: Dict[int, Tuple[int, int, int]],
    threshold: float = 0.5,
) -> np.ndarray:
    """(C, H, W) probabilities -> (H, W, 3) uint8 class colors
    (reference utils/__init__.py:35-43)."""
    C, H, W = masks.shape
    img = np.zeros((H, W, 3), np.uint8)
    for c in range(C):
        img[masks[c] > threshold] = class_2_color[c]
    return img


def side_by_side(*imgs: np.ndarray, axis: int = 1) -> np.ndarray:
    """Concat images, resizing to the first one's shape."""
    base = imgs[0]
    out = [base]
    for im in imgs[1:]:
        if im.shape[:2] != base.shape[:2]:
            im = image_io.resize(im, (base.shape[1], base.shape[0]))
        out.append(im)
    return np.concatenate(out, axis=axis)


def eval_panel(
    rgb: np.ndarray,
    disp_pred: np.ndarray,
    disp_gt: Optional[np.ndarray],
    seg_pred: np.ndarray,
    seg_gt: Optional[np.ndarray],
    class_2_color: Dict[int, Tuple[int, int, int]],
) -> np.ndarray:
    """RGB | pred disp | gt disp  over  RGB | pred seg | gt seg
    (reference utils/__init__.py:646-708)."""
    row1 = [rgb, colorize_disparity(disp_pred)]
    if disp_gt is not None:
        row1.append(colorize_disparity(disp_gt))
    row2 = [rgb, color_segmentation(seg_pred, class_2_color)]
    if seg_gt is not None:
        row2.append(color_segmentation(seg_gt, class_2_color))
    return np.concatenate([side_by_side(*row1), side_by_side(*row2)], axis=0)


def color_by_height(
    points: np.ndarray, index: int = 2, invert: bool = False, cmap: str = "viridis"
) -> np.ndarray:
    """(N, 3) points -> (N, 3) uint8 colors by one coordinate
    (reference color_by_index, utils/__init__.py:347-371)."""
    if len(points) == 0:
        return np.zeros((0, 3), np.uint8)
    h = points[:, index].astype(np.float64)
    finite = np.isfinite(h)
    lo = h[finite].min() if finite.any() else 0.0
    hi = h[finite].max() if finite.any() else 1.0
    norm = (h - lo) / (hi - lo) if hi > lo else np.zeros_like(h)
    if invert:
        norm = 1.0 - norm
    return _colormap(np.clip(norm, 0, 1), cmap)


def semantic_points_to_colors(
    semantic_pc: np.ndarray, class_2_color: Dict[int, Tuple[int, int, int]]
) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 4) [x,y,z,class] -> (points (N,3), colors (N,3))
    (reference bdd_helper.py:577-601)."""
    pts = semantic_pc[:, :3]
    colors = np.asarray(
        [class_2_color[int(c)] for c in semantic_pc[:, 3]], np.uint8
    ) if len(semantic_pc) else np.zeros((0, 3), np.uint8)
    return pts, colors


def save_image(path: str, img: np.ndarray) -> None:
    """Write an RGB image as a PNG (converted to BGR for ``imwrite``, as
    the JAX package converts it for ``cv2.imwrite``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    image_io.imwrite(path, img[..., ::-1])
