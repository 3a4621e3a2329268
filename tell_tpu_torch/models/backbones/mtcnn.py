"""MTCNN face detector, the P/R/O-net cascade, frozen (counterpart of
tell_tpu/models/backbones/mtcnn.py).

tell_tpu's fixed-shape cascade: an image pyramid (factor 0.709, its scales
a host constant per canvas), PNet's 64 best cells per scale (ties: the
lower index first) with a 0.5 NMS per scale and a 0.7 NMS over all, a
budget of 256 boxes regressed and squared; RNet on 24 x 24 crops, ONet on
48 x 48 crops (thresholds 0.6 / 0.7 / 0.7), a "min" NMS, and the boxes
sorted by area. Every stage keeps its box budget with a validity mask;
the NMS are one IoU matrix (MTCNN's +1 area convention) and greedy_keep on
the device. The pyramid resize and the crops are JAX's antialiased linear
resampling (ops/image_resize.py), not torch's.

The tree is tell_tpu's (HWIO convs, [in, out] dense weights, per-channel
PReLU slopes); `prepare_mtcnn` makes the forward's layout (OIHW convs)
once, where the tower is loaded. The dense layers see the conv output
flattened in (W, H, C) order, as facenet-pytorch's permute(0, 3, 2, 1).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.image_resize import resize_linear
from . import fp32_math, load_state
from .yolov3 import crop_and_resize, greedy_keep


@dataclass(frozen=True)
class MTCNNConfig:
    min_face_size: int = 20
    thresholds: tuple[float, float, float] = (0.6, 0.7, 0.7)
    factor: float = 0.709
    boxes_per_scale: int = 64
    stage1_boxes: int = 256
    max_faces: int = 64


# -- networks (NCHW inside; prepare_mtcnn's layout) ---------------------------

def _conv(x, p):
    return F.conv2d(x, p[0], p[1])


def _ceil_maxpool(x, k, s):
    """torch's MaxPool2d(k, s, ceil_mode=True), which tell_tpu pads high
    with -inf: ceil((n - k) / s) + 1 windows, each starting inside."""
    return F.max_pool2d(x, k, s, ceil_mode=True)


def _dense_wht(x, p):
    """The NCHW conv output flattened as (W, H, C), then x @ w + b."""
    flat = x.permute(0, 3, 2, 1).reshape(x.shape[0], -1)
    return flat @ p[0] + p[1]


def _dense(x, p):
    return x @ p[0] + p[1]


def pnet_forward(p: dict, x: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, 3, H, W] -> (reg [B, h, w, 4], face probability [B, h, w])."""
    h = F.prelu(_conv(x, p["conv1"]), p["prelu1"])
    h = _ceil_maxpool(h, 2, 2)
    h = F.prelu(_conv(h, p["conv2"]), p["prelu2"])
    h = F.prelu(_conv(h, p["conv3"]), p["prelu3"])
    cls = torch.softmax(_conv(h, p["conv4_1"]), dim=1)
    reg = _conv(h, p["conv4_2"])
    return reg.permute(0, 2, 3, 1), cls[:, 1]


def rnet_forward(p: dict, x: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [N, 3, 24, 24] -> (reg [N, 4], prob [N])."""
    h = F.prelu(_conv(x, p["conv1"]), p["prelu1"])
    h = _ceil_maxpool(h, 3, 2)
    h = F.prelu(_conv(h, p["conv2"]), p["prelu2"])
    h = _ceil_maxpool(h, 3, 2)
    h = F.prelu(_conv(h, p["conv3"]), p["prelu3"])
    h = F.prelu(_dense_wht(h, p["dense4"]), p["prelu4"])
    prob = torch.softmax(_dense(h, p["dense5_1"]), dim=-1)[:, 1]
    return _dense(h, p["dense5_2"]), prob


def onet_forward(p: dict, x: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [N, 3, 48, 48] -> (reg [N, 4], landmarks [N, 10], prob [N])."""
    h = F.prelu(_conv(x, p["conv1"]), p["prelu1"])
    h = _ceil_maxpool(h, 3, 2)
    h = F.prelu(_conv(h, p["conv2"]), p["prelu2"])
    h = _ceil_maxpool(h, 3, 2)
    h = F.prelu(_conv(h, p["conv3"]), p["prelu3"])
    h = _ceil_maxpool(h, 2, 2)
    h = F.prelu(_conv(h, p["conv4"]), p["prelu4"])
    h = F.prelu(_dense_wht(h, p["dense5"]), p["prelu5"])
    prob = torch.softmax(_dense(h, p["dense6_1"]), dim=-1)[:, 1]
    return _dense(h, p["dense6_2"]), _dense(h, p["dense6_3"]), prob


def prepare_mtcnn(params: dict) -> dict:
    """tell_tpu's tree (torch leaves) in the forward's layout: each conv
    (w, b) with w OIHW; dense layers and PReLU slopes as they are. Made
    once, where the tower is loaded."""
    def net(p):
        return {k: ((v[0].permute(3, 2, 0, 1).contiguous(), v[1])
                    if k.startswith("conv") else v) for k, v in p.items()}
    return {name: net(p) for name, p in params.items()}


def load_mtcnn(path: str, device) -> dict:
    """<path>/state.pt (convert_towers --mtcnn) on `device`, in the
    forward's layout."""
    return prepare_mtcnn(load_state(path, device, "--mtcnn PNET RNET ONET"))


def convert_mtcnn(pnet_sd: dict, rnet_sd: dict, onet_sd: dict) -> dict:
    """facenet-pytorch's {p,r,o}net.pt state dicts -> tell_tpu's tree
    (numpy leaves): conv weights HWIO, dense weights [in, out]."""
    def t(sd, name):
        v = sd[name]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v)

    def conv(sd, name):
        return (np.ascontiguousarray(
                    t(sd, name + ".weight").transpose(2, 3, 1, 0)),
                t(sd, name + ".bias"))

    def dense(sd, name):
        return (np.ascontiguousarray(t(sd, name + ".weight").T),
                t(sd, name + ".bias"))

    def net(sd, convs, prelus, denses):
        p = {f"conv{i}": conv(sd, f"conv{i}") for i in convs}
        p.update({f"prelu{i}": t(sd, f"prelu{i}.weight") for i in prelus})
        p.update({name: dense(sd, name) for name in denses})
        return p

    p = net(pnet_sd, (1, 2, 3), (1, 2, 3), ())
    p["conv4_1"] = conv(pnet_sd, "conv4_1")
    p["conv4_2"] = conv(pnet_sd, "conv4_2")
    r = net(rnet_sd, (1, 2, 3), (1, 2, 3, 4),
            ("dense4", "dense5_1", "dense5_2"))
    o = net(onet_sd, (1, 2, 3, 4), (1, 2, 3, 4, 5),
            ("dense5", "dense6_1", "dense6_2", "dense6_3"))
    return {"pnet": p, "rnet": r, "onet": o}


# -- box math (detect_face.py's helpers, vectorised) --------------------------

def bbreg(boxes: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    w = boxes[:, 2] - boxes[:, 0] + 1
    h = boxes[:, 3] - boxes[:, 1] + 1
    return torch.stack([boxes[:, 0] + reg[:, 0] * w,
                        boxes[:, 1] + reg[:, 1] * h,
                        boxes[:, 2] + reg[:, 2] * w,
                        boxes[:, 3] + reg[:, 3] * h], dim=1)


def rerec(boxes: torch.Tensor) -> torch.Tensor:
    """Boxes made square around their centre."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    side = torch.maximum(w, h)
    x0 = boxes[:, 0] + w * 0.5 - side * 0.5
    y0 = boxes[:, 1] + h * 0.5 - side * 0.5
    return torch.stack([x0, y0, x0 + side, y0 + side], dim=1)


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             thresh: float, method: str = "union") -> torch.Tensor:
    """Greedy NMS keep-mask over fixed-size inputs (+1 area convention;
    "union" or "min" overlap), in the boxes' own order."""
    order = torch.sort(-torch.where(valid, scores, -math.inf),
                       stable=True).indices
    b = boxes[order]
    area = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    lt = torch.maximum(b[:, None, :2], b[None, :, :2])
    rb = torch.minimum(b[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt + 1, min=0)
    inter = wh[..., 0] * wh[..., 1]
    if method == "min":
        denom = torch.minimum(area[:, None], area[None, :])
    else:
        denom = area[:, None] + area[None, :] - inter
    iou = inter / torch.clamp(denom, min=1e-9)
    keep = greedy_keep(iou > thresh, valid[order])
    return torch.empty_like(keep).index_put_((order,), keep)


def pyramid_scales(h: int, w: int, min_face_size: int,
                   factor: float) -> list[float]:
    m = 12.0 / min_face_size
    minl = min(h, w) * m
    scales = []
    scale = m
    while minl >= 12:
        scales.append(scale)
        scale *= factor
        minl *= factor
    return scales


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def detect_faces(params: dict, img: torch.Tensor,
                 cfg: MTCNNConfig = MTCNNConfig()
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """img: [H, W, 3] fp32 in 0..255 on the weights' device -> (boxes
    [max_faces, 4] xyxy, probs [max_faces], valid [max_faces]), by box
    area, largest first. params: prepare_mtcnn's tree."""
    with fp32_math():
        return _detect_faces(params, img, cfg)


def _detect_faces(params, img, cfg):
    H, W, _ = img.shape
    x = (img - 127.5) * 0.0078125

    # stage 1: PNet over the pyramid
    stage = {"boxes": [], "regs": [], "scores": [], "valid": []}
    for scale in pyramid_scales(H, W, cfg.min_face_size, cfg.factor):
        hs, ws = int(H * scale + 1), int(W * scale + 1)
        xi = resize_linear(x, hs, ws)
        reg, prob = pnet_forward(params["pnet"], _nchw(xi[None]))
        gh, gw = prob.shape[1:]
        top, idx = torch.sort(prob.reshape(-1), descending=True, stable=True)
        k = min(cfg.boxes_per_scale, gh * gw)
        top, idx = top[:k], idx[:k]
        gy = torch.div(idx, gw, rounding_mode="floor").to(torch.float32)
        gx = (idx % gw).to(torch.float32)
        # generateBoundingBox: stride 2, cell 12, floor((2 g + off) / scale),
        # the division a product with the fp32 reciprocal, as XLA compiles
        # a division by a constant (it moves a floor at a whole number)
        inv = float(np.float32(1.0) / np.float32(scale))
        boxes = torch.floor(torch.stack([2 * gx + 1, 2 * gy + 1, 2 * gx + 12,
                                         2 * gy + 12], dim=1) * inv)
        valid = top >= cfg.thresholds[0]
        # raw boxes into the global NMS: only its survivors are regressed
        stage["boxes"].append(boxes)
        stage["regs"].append(reg.reshape(-1, 4)[idx])
        stage["scores"].append(top)
        stage["valid"].append(nms_mask(boxes, top, valid, 0.5))
    boxes, regs, scores, valid = (torch.cat(stage[k]) for k in
                                  ("boxes", "regs", "scores", "valid"))
    keep = nms_mask(boxes, scores, valid, 0.7)
    order = torch.sort(-torch.where(keep, scores, -math.inf),
                       stable=True).indices[:cfg.stage1_boxes]
    valid = keep[order]
    boxes = torch.where(valid[:, None],
                        rerec(bbreg(boxes[order], regs[order])), 0.0)

    # stage 2: RNet on 24 x 24 crops
    reg, prob = rnet_forward(params["rnet"],
                             _nchw(crop_and_resize(x, boxes, 24)))
    valid = valid & (prob >= cfg.thresholds[1])
    keep = nms_mask(boxes, prob, valid, 0.7)
    boxes = torch.where(keep[:, None], rerec(bbreg(boxes, reg)), 0.0)

    # stage 3: ONet on 48 x 48 crops
    reg, _lmk, prob = onet_forward(params["onet"],
                                   _nchw(crop_and_resize(x, boxes, 48)))
    valid = keep & (prob >= cfg.thresholds[2])
    boxes = bbreg(boxes, reg)
    keep = nms_mask(boxes, prob, valid, 0.7, method="min")
    scores = torch.where(keep, prob, 0.0)

    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    order = torch.sort(-torch.where(keep, area, -math.inf),
                       stable=True).indices[:cfg.max_faces]
    return boxes[order], scores[order], keep[order]


def extract_faces(img: torch.Tensor, boxes: torch.Tensor,
                  image_size: int = 160) -> torch.Tensor:
    """The faces cropped from img ([H, W, 3], 0..255), resized to
    image_size and prewhitened ((x - 127.5) / 128) for FaceNet: [N,
    image_size, image_size, 3]."""
    return (crop_and_resize(img, boxes, image_size) - 127.5) * (1 / 128)
