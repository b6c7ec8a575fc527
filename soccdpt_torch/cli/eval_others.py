"""Baseline-comparison harness (the port of ``soccdpt_tpu/cli/eval_others.py``;
reference scripts/eval_others.py).

    python -m soccdpt_torch.cli.eval_others -m dpt_swin2_tiny_256 \\
        pt2:exports/soccdpt.pt2 DPT_Hybrid -b <tree> [--device cpu]
    python -m soccdpt_torch.cli.eval_others --list

The reference wraps seven external torch-hub depth estimators (MiDaS
DPTs, monodepth2, manydepth, zerodepth, packnet) behind one interface so
all are scored with identical metrics (reference eval_others.py:42-51).
The registry here covers all of them (``EXTERNAL_BASELINES``, hub-gated:
weights load lazily and a clear RuntimeError is raised when the hub, the
network or a package is unavailable) plus what the reference cannot
score: every in-tree model type, exported programs (``pt2:<path>``, a
``torch.export`` program from ``cli/export.py``, in place of the JAX
package's ``stablehlo:<path>``; ``onnx:<path>``), and any user model through a
``module.path:function`` adapter spec (the function returns
``fn(images_nchw_f32) -> disparity (B, H, W)``). All are scored with the
same SSI-aligned masked depth metrics. In-tree models and exported
programs run on the card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
from typing import Callable, Dict

import numpy as np


def builtin_adapter(model_type: str, version: int = 3, load=None, device=None) -> Callable:
    """Adapter for an in-tree SOccDPT model in bf16: returns a
    disparity-only fn. ``load``: a ``.pth``/``.pt`` reference-layout
    checkpoint or a checkpoint of the port (``cli/train.py::load_weights``)."""
    import torch

    from ..core.config import ModelConfig
    from ..models.bias_cache import build_inference_cache
    from ..models.soccdpt import build_model
    from .train import load_weights

    mcfg = ModelConfig(model_type=model_type, version=version, compute_dtype="bfloat16")
    model = build_model(mcfg, device=device)
    if load:
        load_weights(model, load, version)
    build_inference_cache(model.eval())
    dev = next(model.parameters()).device

    def fn(images: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images, np.float32), device=dev)
        with torch.no_grad():
            return model(x, return_raw=True)[0].float().cpu().numpy()

    return fn


def file_adapter(scheme: str, path: str, device=None) -> Callable:
    """Adapter for a foreign model *file* (the reference scores external
    artifacts with shared metrics, eval_others.py:42-51):

    ``pt2:<path>``: a program written by ``cli/export.py``
    (``torch.export``), on the card unless ``device`` says otherwise; its
    first output is disparity.
    ``onnx:<path>``: an ONNX model through onnxruntime (optional; a clear
    error when it is absent). Its first output is disparity.
    """
    path = os.path.expanduser(path)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if scheme == "pt2":
        import torch

        from ..core.device import resolve_device
        from .run_exported import load_program

        dev = resolve_device(device)
        module = load_program(path, dev)

        def fn(images: np.ndarray) -> np.ndarray:
            x = torch.as_tensor(np.asarray(images, np.float32), device=dev)
            with torch.no_grad():
                out = module(x)
            disp = out[0] if isinstance(out, (tuple, list)) else out
            return disp.float().cpu().numpy()

        return fn
    if scheme == "onnx":
        try:
            import onnxruntime as ort
        except ImportError as e:
            raise RuntimeError(
                "onnx adapter requires onnxruntime, which is not "
                "installed in this environment; export with "
                "soccdpt_torch.cli.export (torch.export) and use pt2:<path>"
            ) from e
        sess = ort.InferenceSession(path)
        name = sess.get_inputs()[0].name

        def fn(images: np.ndarray) -> np.ndarray:
            out = sess.run(None, {name: np.asarray(images, np.float32)})
            return np.asarray(out[0], np.float32)

        return fn
    raise ValueError(f"unknown file adapter scheme {scheme!r}")


def load_adapter(spec: str, device=None) -> Callable:
    """'pt2:<path>' / 'onnx:<path>' / 'module.path:function'."""
    head, rest = spec.split(":", 1)
    if head in ("pt2", "onnx"):
        return file_adapter(head, rest, device)
    mod = importlib.import_module(head)
    return getattr(mod, rest)()


# ---------------------------------------------------------------------------
# External torch-hub baselines: the reference's seven wrappers
# (reference eval_others.py:42-51, 71-200). Every adapter is hub-gated: it
# loads weights lazily on first call and raises a clear RuntimeError when
# the hub, the network or a package is unavailable. Each wrapper owns its
# preprocessing, like the reference's per-model ``self.transform``;
# adapters here consume RAW uint8 HWC frames (``wants_raw``) rather than
# SOccDPT-normalized tensors.
# ---------------------------------------------------------------------------

EXTERNAL_BASELINES = {
    # midas family (reference eval_others.py:71-118)
    "DPT_SwinV2_T_256": {"kind": "midas", "transform": "swin256_transform"},
    # NOTE the reference applies swin256_transform to Hybrid/Large too
    # (eval_others.py:90-118) — that is the wrong normalization for
    # those models (MiDaS ships dpt_transform for them); we use the
    # correct one rather than replicate the defect (SURVEY.md §2.6).
    "DPT_Hybrid": {"kind": "midas", "transform": "dpt_transform"},
    "DPT_Large": {"kind": "midas", "transform": "dpt_transform"},
    # monodepth2 / manydepth (reference eval_others.py:120-155)
    "monodepth2": {"kind": "monodepth2", "model_name": "mono_640x192"},
    "manydepth": {
        "kind": "manydepth",
        "model_name": "KITTI_HR_1024_320",
        "intrinsics_json_path": "media/manydepth/intrinsics.json",
    },
    # TRI-ML/vidar models output DEPTH -> invert to disparity
    # (reference eval_others.py:157-199, 228-241: inv_depth.pow_(-1))
    "zerodepth": {"kind": "vidar", "entry": "ZeroDepth", "scale": 0.5},
    "packnet": {"kind": "vidar", "entry": "PackNet", "resize": (640, 384)},
}


def _hub_load(torch, name, *args, **kwargs):
    """torch.hub.load with a clean failure when the hub is unreachable."""
    try:
        return torch.hub.load(*args, **kwargs)
    except Exception as e:
        raise RuntimeError(
            f"external baseline {name!r} needs torch.hub access "
            f"({args[0]}), which is unavailable here: {e}"
        ) from e


def _resize_hwc(img: np.ndarray, wh) -> np.ndarray:
    """``cv2.resize(img, wh)`` (bilinear; ``wh`` = (W, H)) of a uint8 frame,
    through the port's own resize, which gives OpenCV's bits
    (``data/image_io.py``): the port does not depend on OpenCV."""
    from ..data.image_io import resize

    return resize(img, tuple(wh))


def external_adapter(name: str, camera=None) -> Callable:
    """Adapter for one of the reference's external baselines.

    Returns ``fn(raw_hwc_uint8) -> disparity (1, H', W') float32``; the fn
    carries ``wants_raw = True`` so the harness feeds raw frames (each
    wrapper owns its preprocessing, like the reference's per-model
    ``self.transform``). The models run on the CPU, as the reference's
    wrappers do.
    """
    import torch

    spec = EXTERNAL_BASELINES[name]
    state: Dict[str, object] = {}
    kind = spec["kind"]

    def ensure_loaded():
        if "model" in state:
            return
        if kind == "midas":
            state["model"] = _hub_load(torch, name, "intel-isl/MiDaS", name).eval()
            transforms = _hub_load(torch, name, "intel-isl/MiDaS", "transforms")
            state["transform"] = getattr(transforms, spec["transform"])
        elif kind == "monodepth2":
            try:
                from monodepth2 import monodepth2
            except ImportError as e:
                raise RuntimeError(
                    "baseline 'monodepth2' requires the monodepth2 "
                    "package (github.com/nianticlabs/monodepth2 wrapper), "
                    "not installed here"
                ) from e
            state["model"] = monodepth2(model_name=spec["model_name"])
        elif kind == "manydepth":
            try:
                from manydepth import manydepth
            except ImportError as e:
                raise RuntimeError(
                    "baseline 'manydepth' requires the manydepth package, "
                    "not installed here"
                ) from e
            state["model"] = manydepth(
                model_name=spec["model_name"],
                intrinsics_json_path=spec["intrinsics_json_path"],
            )
        elif kind == "vidar":
            state["model"] = _hub_load(
                torch, name, "TRI-ML/vidar", spec["entry"], pretrained=True, trust_repo=True
            ).eval()
        else:  # pragma: no cover
            raise ValueError(kind)

    def fn(raw: np.ndarray) -> np.ndarray:
        """raw: (H, W, 3) uint8 RGB frame."""
        ensure_loaded()
        with torch.no_grad():
            if kind == "midas":
                t = state["transform"](np.asarray(raw))
                inv = state["model"](t)
                return np.asarray(inv, np.float32).reshape(1, *inv.shape[-2:])
            if kind == "monodepth2":
                img = _resize_hwc(np.asarray(raw, np.uint8), (640, 192))
                disp = np.asarray(state["model"].eval(img), np.float32)
                return disp[None, :, :, 0]
            if kind == "manydepth":
                img = _resize_hwc(np.asarray(raw, np.uint8), (1024, 320))
                disp = np.asarray(state["model"].eval(img, img), np.float32)
                return disp[None]
            # vidar family: normalized CHW in, DEPTH out -> invert
            img = np.asarray(raw, np.float32)
            if "scale" in spec:
                s = spec["scale"]
                img = _resize_hwc(
                    img.astype(np.uint8), (int(img.shape[1] * s), int(img.shape[0] * s))
                ).astype(np.float32)
            else:
                img = _resize_hwc(img.astype(np.uint8), spec["resize"]).astype(np.float32)
            x = torch.tensor(img.transpose(2, 0, 1)[None] / 255.0)
            if spec["entry"] == "ZeroDepth":
                cam = camera
                if cam is None:
                    from ..core.config import CameraConfig

                    cam = CameraConfig()
                k = np.asarray(
                    [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]], np.float32
                ) * spec["scale"]
                k[2, 2] = 1.0
                intr = torch.tensor(k[None])
                depth = state["model"](x, intr).squeeze(0)
            else:
                depth = state["model"](x)[0].squeeze(0)
            depth = np.asarray(depth, np.float32).reshape(1, *x.shape[-2:])
            return 1.0 / np.maximum(depth, 1e-8)

    fn.wants_raw = True
    fn.baseline_name = name
    return fn


def evaluate_adapter(adapter: Callable, dataset, max_samples: int = 10) -> Dict[str, float]:
    """The adapter's SSI-aligned depth metrics, averaged over the first
    ``max_samples`` samples; its disparity is resized to the GT's size
    (bicubic) first."""
    import torch

    from ..ops.resize import resize_nchw
    from ..train.metrics import ssi_aligned_depth_metrics

    sums: Dict[str, list] = {}
    n = min(max_samples, len(dataset))
    for i in range(n):
        s = dataset[i]
        if getattr(adapter, "wants_raw", False):
            # external baselines own their preprocessing (reference
            # eval_others.py per-model self.transform): raw uint8 HWC in
            disp = adapter(np.asarray(s["image_raw"]))
        else:
            disp = adapter(s["image"][None])
        gt = np.asarray(s["disparity"], np.float32)[None]
        mask = np.asarray(s["mask_disp"], bool)[None]
        pred = resize_nchw(torch.from_numpy(np.asarray(disp, np.float32)), gt.shape[-2:],
                           "bicubic", False).numpy()
        m = ssi_aligned_depth_metrics(gt, pred, mask)
        for k, v in m.as_dict().items():
            sums.setdefault(k, []).append(v)
    return {k: float(np.mean(v)) for k, v in sums.items()}


def main(argv=None):
    from ..core.config import TrainConfig
    from .train import build_datasets, dataset_camera

    parser = argparse.ArgumentParser(description="Compare depth baselines")
    parser.add_argument(
        "-m",
        "--models",
        nargs="+",
        default=["dpt_swin2_tiny_256"],
        help="in-tree model types and/or module:fn adapter specs",
    )
    parser.add_argument("-dt", "--dataset", choices=["bdd", "idd"], default="bdd")
    parser.add_argument(
        "-b", "--base_path", default=os.path.expanduser("~/Datasets/Depth_Dataset_Bengaluru")
    )
    parser.add_argument("--num_samples", type=int, default=10)
    parser.add_argument(
        "--list",
        action="store_true",
        help="print the adapter registry (in-tree model types, external "
        "hub baselines, file schemes) and exit",
    )
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    if args.list:
        from ..core.config import MODEL_TYPES

        print(json.dumps({
            "in_tree": sorted(MODEL_TYPES),
            "external": sorted(EXTERNAL_BASELINES),
            "file_schemes": ["pt2:<path>", "onnx:<path>"],
            "custom": "module.path:function",
        }, indent=2))
        return None

    tcfg = TrainConfig(dataset=args.dataset, base_path=args.base_path)
    # transforms keyed by the first in-tree model; adapters receive the
    # same preprocessed input, like the reference's shared interface
    first = next((m for m in args.models if ":" not in m), "dpt_swin2_tiny_256")
    dataset, _, _ = build_datasets(tcfg, first)

    results = []
    for spec in args.models:
        if spec in EXTERNAL_BASELINES:
            adapter = external_adapter(spec, camera=dataset_camera(dataset))
        elif ":" in spec:
            adapter = load_adapter(spec, args.device)
        else:
            adapter = builtin_adapter(spec, device=args.device)
        metrics = evaluate_adapter(adapter, dataset, args.num_samples)
        print(json.dumps({"model": spec, **metrics}))
        results.append({"model": spec, **metrics})
    return results


if __name__ == "__main__":
    main()
