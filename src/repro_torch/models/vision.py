"""GEMEL's vision zoo — the port of ``repro.models.vision``, in two halves:

1. **Layer-spec descriptors** of the paper's model families (ResNet-18/50/
   101/152, VGG16, YOLOv3, TinyYOLOv3, SSD-VGG, SSD-MNet, MobileNetV1,
   InceptionV3, FasterRCNN-R50/R101-FPN): each model is a list of
   ``LayerSpec(name, kind, shape)`` entries from the published
   architectures, so per-layer parameter counts, signatures and memory
   distributions are real while no weight is allocated.  They drive the
   workload simulator (``configs/vision_workloads.py``).

2. **Runnable small CNNs**: forward, the trunk/head serving split, loss,
   accuracy and the calibration taps.  Images are NHWC and conv weights
   HWIO at the API, as in the JAX package; the permute to PyTorch's NCHW /
   OIHW happens inside :func:`_conv`, and the padding reproduces XLA's
   "SAME" (extra row/column at the end).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import flatten_paths, torch_dtype


# ---------------------------------------------------------------------------
# Part 1 — layer-spec descriptors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    name: str
    kind: str  # conv | dwconv | fc | bn
    shape: tuple  # conv: (kh, kw, cin, cout); fc: (din, dout); bn: (c,)
    stride: int = 1  # part of architectural identity (paper §4.1)

    @property
    def params(self) -> int:
        n = int(np.prod(self.shape, dtype=np.int64))
        if self.kind == "bn":
            n *= 2  # scale + bias
        return n

    @property
    def bytes(self) -> int:
        return self.params * 4  # fp32 deployment (paper setting)

    @property
    def signature(self) -> tuple:
        return (self.kind, self.shape, self.stride)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    family: str
    task: str  # classification | detection
    layers: tuple  # tuple[LayerSpec, ...]

    @property
    def params(self) -> int:
        return sum(l.params for l in self.layers)

    @property
    def bytes(self) -> int:
        return sum(l.bytes for l in self.layers)


class _B:
    """Tiny builder: accumulates LayerSpecs with auto-numbered names."""

    def __init__(self):
        self.layers: list[LayerSpec] = []

    def conv(self, name, kh, kw, cin, cout, bn=True, stride=1):
        self.layers.append(LayerSpec(name, "conv", (kh, kw, cin, cout), stride))
        if bn:
            self.layers.append(LayerSpec(name + ".bn", "bn", (cout,)))
        return cout

    def dwconv(self, name, k, c, bn=True, stride=1):
        self.layers.append(LayerSpec(name, "dwconv", (k, k, 1, c), stride))
        if bn:
            self.layers.append(LayerSpec(name + ".bn", "bn", (c,)))
        return c

    def fc(self, name, din, dout):
        self.layers.append(LayerSpec(name, "fc", (din, dout)))
        return dout

    def done(self, name, family, task) -> ModelSpec:
        return ModelSpec(name, family, task, tuple(self.layers))


# -- ResNet -----------------------------------------------------------------

_RESNET_BLOCKS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


def _resnet_body(b: _B, depth: int, prefix: str = "") -> int:
    """Emit the conv body; returns final channel count."""
    blocks = _RESNET_BLOCKS[depth]
    bottleneck = depth >= 50
    b.conv(f"{prefix}conv1", 7, 7, 3, 64, stride=2)
    cin = 64
    for si, (n, c) in enumerate(zip(blocks, [64, 128, 256, 512])):
        for bi in range(n):
            base = f"{prefix}layer{si+1}.{bi}"
            st = 2 if (bi == 0 and si > 0) else 1
            if bottleneck:
                cout = c * 4
                b.conv(f"{base}.conv1", 1, 1, cin, c)
                b.conv(f"{base}.conv2", 3, 3, c, c, stride=st)
                b.conv(f"{base}.conv3", 1, 1, c, cout)
                if bi == 0:
                    b.conv(f"{base}.downsample", 1, 1, cin, cout, stride=st)
                cin = cout
            else:
                b.conv(f"{base}.conv1", 3, 3, cin, c, stride=st)
                b.conv(f"{base}.conv2", 3, 3, c, c)
                if bi == 0 and cin != c:
                    b.conv(f"{base}.downsample", 1, 1, cin, c, stride=st)
                cin = c
    return cin


def resnet(depth: int, n_classes: int = 1000) -> ModelSpec:
    b = _B()
    cin = _resnet_body(b, depth)
    b.fc("fc", cin, n_classes)
    return b.done(f"resnet{depth}", "resnet", "classification")


# -- VGG ----------------------------------------------------------------------

_VGG16_CFG = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]


def _vgg16_convs(b: _B, prefix: str = "") -> int:
    cin, idx = 3, 1
    for n, c in _VGG16_CFG:
        for _ in range(n):
            b.conv(f"{prefix}conv{idx}", 3, 3, cin, c, bn=False)
            cin, idx = c, idx + 1
    return cin


def vgg16(n_classes: int = 1000) -> ModelSpec:
    b = _B()
    _vgg16_convs(b)
    b.fc("fc1", 512 * 7 * 7, 4096)
    b.fc("fc2", 4096, 4096)
    b.fc("fc3", 4096, n_classes)
    return b.done("vgg16", "vgg", "classification")


# -- MobileNetV1 --------------------------------------------------------------

_MNET_CFG = [64, 128, 128, 256, 256, 512, 512, 512, 512, 512, 512, 1024, 1024]


def _mobilenet_body(b: _B, prefix: str = "") -> int:
    cin = b.conv(f"{prefix}conv0", 3, 3, 3, 32, stride=2)
    for i, c in enumerate(_MNET_CFG):
        b.dwconv(f"{prefix}dw{i+1}", 3, cin, stride=2 if c != cin else 1)
        cin = b.conv(f"{prefix}pw{i+1}", 1, 1, cin, c)
    return cin


def mobilenet(n_classes: int = 1000) -> ModelSpec:
    b = _B()
    cin = _mobilenet_body(b)
    b.fc("fc", cin, n_classes)
    return b.done("mobilenet", "mobilenet", "classification")


# -- InceptionV3 --------------------------------------------------------------


def _inception_a(b, prefix, cin, pool):
    b.conv(f"{prefix}.b1x1", 1, 1, cin, 64)
    b.conv(f"{prefix}.b5x5_1", 1, 1, cin, 48)
    b.conv(f"{prefix}.b5x5_2", 5, 5, 48, 64)
    b.conv(f"{prefix}.b3x3dbl_1", 1, 1, cin, 64)
    b.conv(f"{prefix}.b3x3dbl_2", 3, 3, 64, 96)
    b.conv(f"{prefix}.b3x3dbl_3", 3, 3, 96, 96)
    b.conv(f"{prefix}.pool", 1, 1, cin, pool)
    return 64 + 64 + 96 + pool


def _inception_b(b, prefix, cin):  # reduction
    b.conv(f"{prefix}.b3x3", 3, 3, cin, 384, stride=2)
    b.conv(f"{prefix}.b3x3dbl_1", 1, 1, cin, 64)
    b.conv(f"{prefix}.b3x3dbl_2", 3, 3, 64, 96)
    b.conv(f"{prefix}.b3x3dbl_3", 3, 3, 96, 96, stride=2)
    return 384 + 96 + cin


def _inception_c(b, prefix, cin, c7):
    b.conv(f"{prefix}.b1x1", 1, 1, cin, 192)
    b.conv(f"{prefix}.b7_1", 1, 1, cin, c7)
    b.conv(f"{prefix}.b7_2", 1, 7, c7, c7)
    b.conv(f"{prefix}.b7_3", 7, 1, c7, 192)
    b.conv(f"{prefix}.b7dbl_1", 1, 1, cin, c7)
    b.conv(f"{prefix}.b7dbl_2", 7, 1, c7, c7)
    b.conv(f"{prefix}.b7dbl_3", 1, 7, c7, c7)
    b.conv(f"{prefix}.b7dbl_4", 7, 1, c7, c7)
    b.conv(f"{prefix}.b7dbl_5", 1, 7, c7, 192)
    b.conv(f"{prefix}.pool", 1, 1, cin, 192)
    return 192 * 4


def _inception_d(b, prefix, cin):  # reduction
    b.conv(f"{prefix}.b3x3_1", 1, 1, cin, 192)
    b.conv(f"{prefix}.b3x3_2", 3, 3, 192, 320, stride=2)
    b.conv(f"{prefix}.b7x7_1", 1, 1, cin, 192)
    b.conv(f"{prefix}.b7x7_2", 1, 7, 192, 192)
    b.conv(f"{prefix}.b7x7_3", 7, 1, 192, 192)
    b.conv(f"{prefix}.b7x7_4", 3, 3, 192, 192, stride=2)
    return 320 + 192 + cin


def _inception_e(b, prefix, cin):
    b.conv(f"{prefix}.b1x1", 1, 1, cin, 320)
    b.conv(f"{prefix}.b3x3_1", 1, 1, cin, 384)
    b.conv(f"{prefix}.b3x3_2a", 1, 3, 384, 384)
    b.conv(f"{prefix}.b3x3_2b", 3, 1, 384, 384)
    b.conv(f"{prefix}.b3x3dbl_1", 1, 1, cin, 448)
    b.conv(f"{prefix}.b3x3dbl_2", 3, 3, 448, 384)
    b.conv(f"{prefix}.b3x3dbl_3a", 1, 3, 384, 384)
    b.conv(f"{prefix}.b3x3dbl_3b", 3, 1, 384, 384)
    b.conv(f"{prefix}.pool", 1, 1, cin, 192)
    return 320 + 768 + 768 + 192


def inception_v3(n_classes: int = 1000) -> ModelSpec:
    b = _B()
    b.conv("conv1a", 3, 3, 3, 32, stride=2)
    b.conv("conv2a", 3, 3, 32, 32)
    b.conv("conv2b", 3, 3, 32, 64)
    b.conv("conv3b", 1, 1, 64, 80)
    b.conv("conv4a", 3, 3, 80, 192)
    c = 192
    for i, pool in enumerate([32, 64, 64]):
        c = _inception_a(b, f"mixed5{chr(98+i)}", c, pool)
    c = _inception_b(b, "mixed6a", c)
    for i, c7 in enumerate([128, 160, 160, 192]):
        c = _inception_c(b, f"mixed6{chr(98+i)}", c, c7)
    c = _inception_d(b, "mixed7a", c)
    c = _inception_e(b, "mixed7b", c)
    c = _inception_e(b, "mixed7c", c)
    b.fc("fc", c, n_classes)
    return b.done("inceptionv3", "inception", "classification")


# -- YOLOv3 / TinyYOLOv3 ------------------------------------------------------


def _darknet53(b: _B) -> list[int]:
    """Darknet-53 body; returns route channel list [256, 512, 1024]."""
    b.conv("conv0", 3, 3, 3, 32)
    cin = 32
    for si, (c, n) in enumerate([(64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)]):
        b.conv(f"down{si}", 3, 3, cin, c, stride=2)
        cin = c
        for ri in range(n):
            b.conv(f"res{si}.{ri}.conv1", 1, 1, c, c // 2)
            b.conv(f"res{si}.{ri}.conv2", 3, 3, c // 2, c)
    return [256, 512, 1024]


def _yolo_head(b: _B, prefix: str, cin: int, mid: int, n_out: int = 255):
    for i in range(3):
        b.conv(f"{prefix}.conv{2*i}", 1, 1, cin if i == 0 else 2 * mid, mid)
        b.conv(f"{prefix}.conv{2*i+1}", 3, 3, mid, 2 * mid)
    b.conv(f"{prefix}.out", 1, 1, 2 * mid, n_out, bn=False)


def yolov3(n_classes: int = 80) -> ModelSpec:
    n_out = 3 * (5 + n_classes)
    b = _B()
    _darknet53(b)
    _yolo_head(b, "head0", 1024, 512, n_out)
    b.conv("route0", 1, 1, 512, 256)
    _yolo_head(b, "head1", 512 + 256, 256, n_out)
    b.conv("route1", 1, 1, 256, 128)
    _yolo_head(b, "head2", 256 + 128, 128, n_out)
    return b.done("yolov3", "yolo", "detection")


def tiny_yolov3(n_classes: int = 80) -> ModelSpec:
    n_out = 3 * (5 + n_classes)
    b = _B()
    cin = 3
    for i, c in enumerate([16, 32, 64, 128, 256, 512]):
        cin = b.conv(f"conv{i}", 3, 3, cin, c)
    b.conv("conv6", 3, 3, 512, 1024)
    b.conv("conv7", 1, 1, 1024, 256)
    b.conv("head0.conv", 3, 3, 256, 512)
    b.conv("head0.out", 1, 1, 512, n_out, bn=False)
    b.conv("route", 1, 1, 256, 128)
    b.conv("head1.conv", 3, 3, 128 + 256, 256)
    b.conv("head1.out", 1, 1, 256, n_out, bn=False)
    return b.done("tiny-yolov3", "yolo", "detection")


# -- SSD ----------------------------------------------------------------------


def ssd_vgg(n_classes: int = 21) -> ModelSpec:
    b = _B()
    _vgg16_convs(b)
    b.conv("fc6", 3, 3, 512, 1024, bn=False)  # dilated conv (converted fc)
    b.conv("fc7", 1, 1, 1024, 1024, bn=False)
    extras = [(1024, 256, 512), (512, 128, 256), (256, 128, 256), (256, 128, 256)]
    for i, (cin, mid, cout) in enumerate(extras):
        b.conv(f"extra{i}.1", 1, 1, cin, mid, bn=False)
        b.conv(f"extra{i}.2", 3, 3, mid, cout, bn=False, stride=2 if i < 2 else 1)
    sources = [512, 1024, 512, 256, 256, 256]
    anchors = [4, 6, 6, 6, 4, 4]
    for i, (c, a) in enumerate(zip(sources, anchors)):
        b.conv(f"loc{i}", 3, 3, c, a * 4, bn=False)
        b.conv(f"conf{i}", 3, 3, c, a * n_classes, bn=False)
    return b.done("ssd-vgg", "ssd", "detection")


def ssd_mnet(n_classes: int = 21) -> ModelSpec:
    b = _B()
    _mobilenet_body(b)
    extras = [(1024, 256, 512), (512, 128, 256), (256, 128, 256), (256, 64, 128)]
    for i, (cin, mid, cout) in enumerate(extras):
        b.conv(f"extra{i}.1", 1, 1, cin, mid)
        b.conv(f"extra{i}.2", 3, 3, mid, cout, stride=2)
    sources = [512, 1024, 512, 256, 256, 128]
    anchors = [3, 6, 6, 6, 6, 6]
    for i, (c, a) in enumerate(zip(sources, anchors)):
        b.conv(f"loc{i}", 3, 3, c, a * 4, bn=False)
        b.conv(f"conf{i}", 3, 3, c, a * n_classes, bn=False)
    return b.done("ssd-mnet", "ssd", "detection")


# -- Faster R-CNN (ResNet-FPN) ------------------------------------------------


def frcnn(depth: int, n_classes: int = 91) -> ModelSpec:
    b = _B()
    _resnet_body(b, depth)
    # FPN
    for i, c in enumerate([256, 512, 1024, 2048]):
        b.conv(f"fpn.lateral{i}", 1, 1, c, 256, bn=False)
        b.conv(f"fpn.out{i}", 3, 3, 256, 256, bn=False)
    # RPN
    b.conv("rpn.conv", 3, 3, 256, 256, bn=False)
    b.conv("rpn.cls", 1, 1, 256, 3, bn=False)
    b.conv("rpn.bbox", 1, 1, 256, 12, bn=False)
    # Box head (TwoMLPHead) — the paper's "two heavy layers near the end"
    b.fc("box_head.fc6", 256 * 7 * 7, 1024)
    b.fc("box_head.fc7", 1024, 1024)
    b.fc("box_pred.cls", 1024, n_classes)
    b.fc("box_pred.bbox", 1024, n_classes * 4)
    return b.done(f"frcnn-r{depth}", "frcnn", "detection")


# -- Registry of paper model ids ----------------------------------------------

SPEC_BUILDERS: dict[str, Callable[[], ModelSpec]] = {
    "r18": lambda: resnet(18),
    "r50": lambda: resnet(50),
    "r101": lambda: resnet(101),
    "r152": lambda: resnet(152),
    "vgg": vgg16,
    "mnet": mobilenet,
    "inception": inception_v3,
    "yolo": yolov3,
    "tiny-yolo": tiny_yolov3,
    "ssd-vgg": ssd_vgg,
    "ssd-mnet": ssd_mnet,
    "frcnn-r50": lambda: frcnn(50),
    "frcnn-r101": lambda: frcnn(101),
}

_SPEC_CACHE: dict[str, ModelSpec] = {}


def get_spec(model_id: str) -> ModelSpec:
    if model_id not in _SPEC_CACHE:
        _SPEC_CACHE[model_id] = SPEC_BUILDERS[model_id]()
    return _SPEC_CACHE[model_id]


# ---------------------------------------------------------------------------
# Part 2 — runnable small CNNs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SmallCNNConfig:
    """Mini vision model over (B, 32, 32, 3) images."""

    name: str = "small-cnn"
    family: str = "resnet"  # resnet | vgg
    depth: int = 2  # blocks per stage
    width: int = 16  # base channels
    n_stages: int = 3
    task: str = "classification"  # classification | detection
    n_classes: int = 10
    n_anchors: int = 4  # detection head outputs per cell
    dtype: str = "float32"  # numpy dtype name


def _conv_w(gen, kh, kw, cin, cout, dtype, device):
    return L.normal(gen, (kh, kw, cin, cout), math.sqrt(2.0 / (kh * kw * cin)),
                    dtype, device)


def init_small_cnn(cfg: SmallCNNConfig, seed: int = 0, device=None) -> dict:
    device = resolve_device(device)
    gen = L.make_generator(seed, device)
    dt = torch_dtype(cfg.dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    p: dict = {"stem": {"w": _conv_w(gen, 3, 3, 3, cfg.width, dt, device),
                        "b": zeros(cfg.width)}}
    cin = cfg.width
    for s in range(cfg.n_stages):
        cout = cfg.width * (2 ** s)
        stage: dict = {}
        for d in range(cfg.depth):
            blk = {
                "conv1": {"w": _conv_w(gen, 3, 3, cin, cout, dt, device), "b": zeros(cout)},
                "conv2": {"w": _conv_w(gen, 3, 3, cout, cout, dt, device), "b": zeros(cout)},
            }
            if cfg.family == "resnet" and cin != cout:
                blk["proj"] = {"w": _conv_w(gen, 1, 1, cin, cout, dt, device)}
            stage[str(d)] = blk
            cin = cout
        p[f"stage{s}"] = stage
    if cfg.task == "classification":
        p["head"] = {
            "fc1": {"w": L.normal(gen, (cin, 4 * cin), 1 / math.sqrt(cin), dt, device),
                    "b": zeros(4 * cin)},
            "fc2": {"w": L.normal(gen, (4 * cin, cfg.n_classes), 1 / math.sqrt(4 * cin),
                                  dt, device),
                    "b": zeros(cfg.n_classes)},
        }
    else:  # detection: per-cell loc (4) + conf (n_classes) maps
        A = cfg.n_anchors
        p["head"] = {
            "conv": {"w": _conv_w(gen, 3, 3, cin, 2 * cin, dt, device), "b": zeros(2 * cin)},
            "loc": {"w": _conv_w(gen, 1, 1, 2 * cin, A * 4, dt, device), "b": zeros(A * 4)},
            "conf": {"w": _conv_w(gen, 1, 1, 2 * cin, A * cfg.n_classes, dt, device),
                     "b": zeros(A * cfg.n_classes)},
        }
    return p


def _same_pad(size: int, k: int, stride: int) -> tuple:
    """XLA/TF "SAME": out = ceil(size / stride), the odd pixel padded last."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, p: dict, stride: int = 1) -> torch.Tensor:
    """NHWC x HWIO conv with "SAME" padding (+ bias), NHWC out."""
    w = p["w"]
    kh, kw = w.shape[0], w.shape[1]
    ph, pw = _same_pad(x.shape[1], kh, stride), _same_pad(x.shape[2], kw, stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride).permute(0, 2, 3, 1)
    if "b" in p:
        y = y + p["b"]
    return y


def small_cnn_features(cfg: SmallCNNConfig, params: dict, images: torch.Tensor,
                       taps: Optional[dict] = None) -> torch.Tensor:
    """Trunk (stem + stages) — the *prefix* the serving engine runs once per
    micro-batch when the trunk's weights are merged across models.
    ``taps``, when given, collects each layer's response keyed by param-path
    prefix ("stem", "stage0/0/conv1", ...): post-relu for stem/conv1, the
    raw conv output for conv2/proj (pre-residual, pre-relu) — what changes
    when THAT layer's weights are swapped."""
    x = torch.relu(_conv(images, params["stem"]))
    if taps is not None:
        taps["stem"] = x
    for s in range(cfg.n_stages):
        for d in range(cfg.depth):
            p = params[f"stage{s}"][str(d)]
            stride = 2 if d == 0 and s > 0 else 1
            h1 = torch.relu(_conv(x, p["conv1"], stride))
            h = _conv(h1, p["conv2"])
            if taps is not None:
                taps[f"stage{s}/{d}/conv1"] = h1
                taps[f"stage{s}/{d}/conv2"] = h
            if cfg.family == "resnet":
                sc = x
                if "proj" in p:
                    sc = _conv(sc, p["proj"], stride)
                    if taps is not None:
                        taps[f"stage{s}/{d}/proj"] = sc
                elif stride != 1:
                    sc = sc[:, ::stride, ::stride, :]
                h = h + sc
            x = torch.relu(h)
    return x


def small_cnn_head(cfg: SmallCNNConfig, params: dict, feats: torch.Tensor,
                   taps: Optional[dict] = None) -> torch.Tensor:
    """Task head over trunk features — the private *suffix*."""
    if cfg.task == "classification":
        feat = feats.mean(dim=(1, 2))
        h = torch.relu(feat @ params["head"]["fc1"]["w"] + params["head"]["fc1"]["b"])
        out = h @ params["head"]["fc2"]["w"] + params["head"]["fc2"]["b"]
        if taps is not None:
            taps["head/fc1"], taps["head/fc2"] = h, out
        return out
    h = torch.relu(_conv(feats, params["head"]["conv"]))
    loc = _conv(h, params["head"]["loc"])
    conf = _conv(h, params["head"]["conf"])
    if taps is not None:
        taps["head/conv"], taps["head/loc"], taps["head/conf"] = h, loc, conf
    return torch.cat([loc, conf], dim=-1)


@torch.no_grad()
def small_cnn_layer_activations(cfg: SmallCNNConfig, params: dict,
                                images: torch.Tensor) -> dict:
    """Calibration-batch activations for every layer, keyed by param-path
    prefix, as float32 numpy on the host — the probes the
    representation-similarity scorer consumes.  Run the same ``images``
    through every candidate model so similarities compare responses to
    identical inputs."""
    taps: dict = {}
    small_cnn_head(cfg, params, small_cnn_features(cfg, params, images, taps=taps), taps=taps)
    return {k: v.float().cpu().numpy() for k, v in taps.items()}


def small_cnn_forward(cfg: SmallCNNConfig, params: dict, images: torch.Tensor):
    """images (B, 32, 32, 3).  Classification: logits (B, n_classes).
    Detection: (B, H', W', n_anchors*(4+n_classes)) dense predictions."""
    return small_cnn_head(cfg, params, small_cnn_features(cfg, params, images))


def small_cnn_loss(cfg: SmallCNNConfig, params: dict, batch: dict) -> torch.Tensor:
    out = small_cnn_forward(cfg, params, batch["images"])
    if cfg.task == "classification":
        logp = torch.log_softmax(out.float(), dim=-1)
        return -torch.mean(logp.gather(-1, batch["labels"][:, None].long()))
    # detection: smooth-L1 on loc + CE on conf against dense targets
    A = cfg.n_anchors
    loc, conf = out[..., :4 * A], out[..., 4 * A:]
    B, H, W, _ = conf.shape
    logp = torch.log_softmax(conf.reshape(B, H, W, A, cfg.n_classes).float(), dim=-1)
    ce = -torch.mean(logp.gather(-1, batch["cls_targets"][..., None].long()))
    diff = loc.float() - batch["loc_targets"]
    l1 = torch.where(diff.abs() < 1.0, 0.5 * diff * diff, diff.abs() - 0.5)
    return ce + torch.mean(l1)


def small_cnn_accuracy(cfg: SmallCNNConfig, params: dict, batch: dict) -> torch.Tensor:
    """Classification: top-1.  Detection: per-cell argmax agreement."""
    out = small_cnn_forward(cfg, params, batch["images"])
    if cfg.task == "classification":
        return torch.mean((out.argmax(-1) == batch["labels"]).float())
    A = cfg.n_anchors
    conf = out[..., 4 * A:]
    B, H, W, _ = conf.shape
    pred = conf.reshape(B, H, W, A, cfg.n_classes).argmax(-1)
    return torch.mean((pred == batch["cls_targets"]).float())


def small_cnn_prefix_paths(cfg: SmallCNNConfig, params: dict) -> frozenset:
    """Flat param paths read by :func:`small_cnn_features`."""
    return frozenset(p for p in flatten_paths(params) if not p.startswith("head/"))


def small_cnn_suffix_paths(cfg: SmallCNNConfig, params: dict) -> frozenset:
    """Flat param paths read by :func:`small_cnn_head` — the private-suffix
    leaves the serving engine stacks into a bank."""
    return frozenset(p for p in flatten_paths(params) if p.startswith("head/"))


def small_cnn_bank_head(cfg: SmallCNNConfig, bank_params: dict,
                        feats: torch.Tensor) -> torch.Tensor:
    """Every private head of a merged group at once.  ``bank_params`` holds
    the head leaves stacked on a leading bank axis N; ``feats`` are the
    shared trunk features (B, H', W', C).  Returns (N, B, ...): row ``n``
    equals ``small_cnn_head`` on member ``n``'s params.

    Classification heads run as two ``ops.bank_matmul`` grouped GEMMs
    (broadcast features + bias, then banked hidden + bias); detection heads
    are convolutions with no bank kernel and run member by member."""
    h = bank_params["head"]
    if cfg.task != "classification":
        n_bank = h["conv"]["w"].shape[0]
        return torch.stack([
            small_cnn_head(cfg, {"head": {l: {k: v[i] for k, v in lp.items()}
                                          for l, lp in h.items()}}, feats)
            for i in range(n_bank)])
    feat = feats.mean(dim=(1, 2))  # (B, C), shared across the bank
    hid = torch.relu(ops.bank_matmul(feat.contiguous(), h["fc1"]["w"], h["fc1"]["b"]))
    out = ops.bank_matmul(hid.to(feats.dtype), h["fc2"]["w"], h["fc2"]["b"])
    return out.to(feats.dtype)
