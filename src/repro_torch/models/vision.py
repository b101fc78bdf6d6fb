"""Runnable small CNNs for GEMEL's vision experiments — the port of the
small_cnn half of ``repro.models.vision`` (the layer-spec descriptor zoo
waits for a later slice): forward, the trunk/head serving split, loss,
accuracy and the calibration taps.

Images are NHWC and conv weights HWIO at the API, as in the JAX package;
the permute to PyTorch's NCHW / OIHW happens inside :func:`_conv`, and the
padding reproduces XLA's "SAME" (extra row/column at the end).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import flatten_paths, torch_dtype


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
