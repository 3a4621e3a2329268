"""YOLOv3-SPP object detector, frozen (counterpart of
tell_tpu/models/backbones/yolov3.py).

A 416 letterboxed canvas -> up to `max_det` boxes, whose 224 x 224 crops
the pooled ResNet-152 embeds into the `obj` context (serving/vision.py).
The architecture is a module-def list (`yolov3_spp_module_defs`, darknet
indexing; `parse_darknet_cfg` reads a user's cfg into the same form);
`load_darknet_weights` reads darknet's binary .weights into tell_tpu's tree
(HWIO convs, batch norm folded into scale / bias with darknet's eps 1e-5),
with int keys under "convs". The convs are cuDNN's on NCHW activations
with OIHW weights, the layout `prepare_yolov3` makes once where the tower
is loaded; yolov3_forward takes only that layout and pins fp32.

The detection head decodes as tell_tpu's (sigmoid xy + cell, exp wh times
the anchor, both by the stride; sigmoid objectness and classes), rows in
anchor-major order, which the top-k below depends on. `nms_fixed` keeps
tell_tpu's fixed shapes: the 256 best scores (ties: the lower index
first), one IoU matrix with a per-class coordinate offset, greedy
suppression (`greedy_keep`, on the device), the kept rows first.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.image_resize import scale_and_translate
from . import fp32_math, load_state

ANCHORS = ((10, 13), (16, 30), (33, 23), (30, 61), (62, 45), (59, 119),
           (116, 90), (156, 198), (373, 326))


def yolov3_spp_module_defs(num_classes: int = 80) -> list[dict]:
    """The yolov3-spp architecture as a module-def list (darknet indexing:
    one entry per block after [net])."""
    defs: list[dict] = []

    def conv(filters, size, stride=1, bn=True, act="leaky"):
        defs.append({"type": "convolutional", "filters": filters,
                     "size": size, "stride": stride, "bn": bn,
                     "activation": act})

    def stage(filters, blocks):
        conv(filters, 3, 2)
        for _ in range(blocks):
            conv(filters // 2, 1)
            conv(filters, 3)
            defs.append({"type": "shortcut", "from": -3})

    no = 3 * (num_classes + 5)  # 255
    # darknet-53 backbone
    conv(32, 3)
    stage(64, 1)
    stage(128, 2)
    stage(256, 8)    # ends at module index 36
    stage(512, 8)    # ends at module index 61
    stage(1024, 4)
    # SPP head, scale 1 (stride 32)
    conv(512, 1); conv(1024, 3); conv(512, 1)  # noqa: E702
    defs.append({"type": "maxpool", "size": 5, "stride": 1})
    defs.append({"type": "route", "layers": (-2,)})
    defs.append({"type": "maxpool", "size": 9, "stride": 1})
    defs.append({"type": "route", "layers": (-4,)})
    defs.append({"type": "maxpool", "size": 13, "stride": 1})
    defs.append({"type": "route", "layers": (-1, -3, -5, -6)})
    conv(512, 1); conv(1024, 3); conv(512, 1); conv(1024, 3)  # noqa: E702
    conv(no, 1, bn=False, act="linear")
    defs.append({"type": "yolo", "mask": (6, 7, 8), "classes": num_classes})
    # scale 2 (stride 16)
    defs.append({"type": "route", "layers": (-4,)})
    conv(256, 1)
    defs.append({"type": "upsample", "stride": 2})
    defs.append({"type": "route", "layers": (-1, 61)})
    conv(256, 1); conv(512, 3); conv(256, 1); conv(512, 3)  # noqa: E702
    conv(256, 1); conv(512, 3)  # noqa: E702
    conv(no, 1, bn=False, act="linear")
    defs.append({"type": "yolo", "mask": (3, 4, 5), "classes": num_classes})
    # scale 3 (stride 8)
    defs.append({"type": "route", "layers": (-4,)})
    conv(128, 1)
    defs.append({"type": "upsample", "stride": 2})
    defs.append({"type": "route", "layers": (-1, 36)})
    conv(128, 1); conv(256, 3); conv(128, 1); conv(256, 3)  # noqa: E702
    conv(128, 1); conv(256, 3)  # noqa: E702
    conv(no, 1, bn=False, act="linear")
    defs.append({"type": "yolo", "mask": (0, 1, 2), "classes": num_classes})
    return defs


def parse_darknet_cfg(text: str) -> list[dict]:
    """Parse a darknet .cfg into the same module-def list (skips [net])."""
    defs: list[dict] = []
    current: dict | None = None
    for raw in text.splitlines():
        line = raw.split("#")[0].strip()
        if not line:
            continue
        if line.startswith("["):
            current = {"type": line.strip("[]")}
            if current["type"] != "net":
                defs.append(current)
            continue
        key, value = (s.strip() for s in line.split("=", 1))
        if current is None:
            continue
        if key in ("layers", "mask", "from"):
            vals = tuple(int(v) for v in value.replace(",", " ").split())
            current[key] = vals if key != "from" else vals[0]
        elif key == "anchors":
            nums = [int(float(v)) for v in value.replace(",", " ").split()]
            current[key] = tuple(zip(nums[::2], nums[1::2]))
        elif key in ("filters", "size", "stride", "classes", "pad"):
            current[key] = int(value)
        elif key == "activation":
            current[key] = value
        elif key == "batch_normalize":
            current["bn"] = bool(int(value))
    for d in defs:
        d.setdefault("bn", False)
        if d["type"] == "convolutional" and "activation" not in d:
            d["activation"] = "linear"
    return defs


def channel_plan(defs: list[dict]) -> list[int]:
    """Each module's output channels, after the input's 3 (route and
    shortcut topology followed)."""
    channels = [3]
    for i, d in enumerate(defs):
        if d["type"] == "convolutional":
            channels.append(d["filters"])
        elif d["type"] == "route":
            layers = [l if l >= 0 else i + l for l in d["layers"]]
            channels.append(sum(channels[l + 1] for l in layers))
        else:
            channels.append(channels[-1])
    return channels


def load_darknet_weights(defs: list[dict], path: str) -> dict:
    """darknet's binary .weights -> tell_tpu's tree (numpy leaves): the
    header (major, minor, revision; then the images seen, int64 from
    version 0.2), then per conv either the batch norm's bias, weight,
    mean and variance (folded: scale = w / sqrt(var + 1e-5), bias = b -
    mean * scale) or the conv bias, then the OIHW kernel (kept HWIO)."""
    with open(path, "rb") as f:
        header = np.fromfile(f, np.int32, 3)
        np.fromfile(f, np.int64 if header[0] * 10 + header[1] >= 2 else
                    np.int32, 1)  # images seen
        buf = np.fromfile(f, np.float32)
    pos = 0
    convs: dict = {}
    channels = channel_plan(defs)
    for i, d in enumerate(defs):
        if d["type"] != "convolutional":
            continue
        cin, k, cout = channels[i], d["size"], d["filters"]
        p: dict = {}
        if d.get("bn", True):
            bn_b, bn_w, bn_m, bn_v = (buf[pos + j * cout:pos + (j + 1) * cout]
                                      for j in range(4))
            pos += 4 * cout
            scale = bn_w / np.sqrt(bn_v + 1e-5)  # darknet BN eps
            p["scale"] = scale
            p["bias"] = bn_b - bn_m * scale
        else:
            p["b"] = buf[pos:pos + cout]
            pos += cout
        n = cout * cin * k * k
        w = buf[pos:pos + n].reshape(cout, cin, k, k)
        pos += n
        p["w"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
        convs[i] = p
    if pos != len(buf):
        raise ValueError(f"{path}: the cfg uses {pos} of the file's "
                         f"{len(buf)} weights")
    return {"convs": convs}


def prepare_yolov3(params: dict) -> dict:
    """tell_tpu's tree (torch leaves) in the forward's layout: conv
    weights OIHW, scale / bias / b [C, 1, 1]. Made once, where the tower
    is loaded."""
    return {"convs": {i: {k: (v.permute(3, 2, 0, 1).contiguous()
                              if k == "w" else v.reshape(-1, 1, 1))
                          for k, v in p.items()}
                      for i, p in params["convs"].items()}}


def load_yolov3(path: str, device) -> dict:
    """<path>/state.pt (convert_towers --yolo-cfg/--yolo-weights) on
    `device`, in the forward's layout."""
    return prepare_yolov3(load_state(path, device,
                                     "--yolo-cfg CFG --yolo-weights W"))


def _decode_yolo(p: torch.Tensor, mask: tuple[int, ...], num_classes: int,
                 img_size: int) -> torch.Tensor:
    """p: [B, 3 * (nc + 5), ny, nx] -> [B, 3 * ny * nx, nc + 5] decoded
    boxes, anchor-major."""
    B, _, ny, nx = p.shape
    na, no = len(mask), num_classes + 5
    stride = img_size // nx
    p = p.reshape(B, na, no, ny, nx).permute(0, 1, 3, 4, 2)
    gy, gx = torch.meshgrid(
        torch.arange(ny, dtype=p.dtype, device=p.device),
        torch.arange(nx, dtype=p.dtype, device=p.device), indexing="ij")
    anchors = torch.tensor([ANCHORS[m] for m in mask], dtype=p.dtype,
                           device=p.device)[:, None, None, :]
    xy = (torch.sigmoid(p[..., 0:2]) + torch.stack([gx, gy], -1)) * stride
    wh = torch.exp(p[..., 2:4]) * anchors
    conf = torch.sigmoid(p[..., 4:])
    return torch.cat([xy, wh, conf], dim=-1).reshape(B, na * ny * nx, no)


def yolov3_forward(params: dict, defs: list[dict], x: torch.Tensor
                   ) -> torch.Tensor:
    """x: [B, S, S, 3] in [0, 1] -> decoded detections [B, N, nc + 5].
    params: prepare_yolov3's tree."""
    img_size = x.shape[1]
    outputs: list[torch.Tensor] = []
    detections = []
    h = x.permute(0, 3, 1, 2).contiguous()
    with fp32_math():
        for i, d in enumerate(defs):
            t = d["type"]
            if t == "convolutional":
                p = params["convs"][i]
                h = F.conv2d(h, p["w"], stride=d["stride"],
                             padding=d["size"] // 2)
                h = h * p["scale"] + p["bias"] if "scale" in p else h + p["b"]
                if d["activation"] == "leaky":
                    h = F.leaky_relu(h, 0.1)
            elif t == "shortcut":
                h = h + outputs[i + d["from"]]
            elif t == "route":
                layers = [l if l >= 0 else i + l for l in d["layers"]]
                h = torch.cat([outputs[l] for l in layers], dim=1)
            elif t == "maxpool":     # -inf padding, as XLA's reduce_window
                h = F.max_pool2d(h, d["size"], d["stride"],
                                 padding=d["size"] // 2)
            elif t == "upsample":
                h = F.interpolate(h, scale_factor=2, mode="nearest")
            elif t == "yolo":
                detections.append(_decode_yolo(h, d["mask"], d["classes"],
                                               img_size))
            outputs.append(h)
    return torch.cat(detections, dim=1)


def greedy_keep(over: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """The greedy NMS of tell_tpu's fori_loops: rows in order, row i kept
    when `alive[i]` and no kept row j < i has over[j, i]; returns the kept
    mask. It is a triangular system, so it is solved on the device by
    updating every row at once from the last mask until the mask stops
    changing (row i is final after i + 1 updates; a mask that an update
    leaves as it was is the system's one solution), looking at the host
    every 8 updates."""
    n = alive.shape[0]
    upper = (over & torch.ones(n, n, dtype=torch.bool, device=over.device)
             .triu(1)).to(torch.float32)
    keep = alive
    for it in range(n + 1):
        new = alive & ((keep.to(torch.float32) @ upper) == 0)
        if (it % 8 == 7 or it == n) and torch.equal(new, keep):
            return new
        keep = new
    return keep


def nms_fixed(dets: torch.Tensor, conf_thres: float = 0.3,
              iou_thres: float = 0.6, pre_top_k: int = 256,
              max_det: int = 64
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Static-shape class-aware NMS. dets: [N, nc + 5] (centre xywh, obj,
    class probs) -> (boxes xyxy [max_det, 4], scores [max_det], valid
    [max_det])."""
    obj = dets[:, 4]
    cls_prob = dets[:, 5:] * obj[:, None]
    cls_id = torch.argmax(cls_prob, dim=-1)     # the first of equal maxima
    score = cls_prob.amax(dim=-1)
    score = torch.where(score > conf_thres, score, torch.zeros_like(score))
    xy, wh = dets[:, :2], dets[:, 2:4]
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)

    k = min(pre_top_k, dets.shape[0])
    top_score, idx = torch.sort(score, descending=True, stable=True)
    top_score, idx = top_score[:k], idx[:k]
    top_boxes = boxes[idx]
    # per-class offset: boxes of different classes never overlap
    nb = top_boxes + cls_id[idx].to(torch.float32)[:, None] * 8192.0
    area = (torch.clamp(nb[:, 2] - nb[:, 0], min=0)
            * torch.clamp(nb[:, 3] - nb[:, 1], min=0))
    lt = torch.maximum(nb[:, None, :2], nb[None, :, :2])
    rb = torch.minimum(nb[:, None, 2:], nb[None, :, 2:])
    wh_i = torch.clamp(rb - lt, min=0)
    inter = wh_i[..., 0] * wh_i[..., 1]
    iou = inter / torch.clamp(area[:, None] + area[None, :] - inter,
                              min=1e-9)
    keep = greedy_keep(iou > iou_thres, top_score > 0)
    order = torch.sort((~keep).to(torch.uint8), stable=True).indices
    order = order[:max_det]
    return top_boxes[order], top_score[order], keep[order]


def crop_and_resize(image: torch.Tensor, boxes: torch.Tensor,
                    out_size: int = 224) -> torch.Tensor:
    """[H, W, 3] and xyxy boxes [N, 4] -> [N, out_size, out_size, 3], as
    tell_tpu's jax.image.scale_and_translate per box (bilinear, antialias):
    scale out / (box side), a degenerate side's scale taken from 1e-6. A
    division by a constant is a product with its fp32 reciprocal, as XLA
    compiles tell_tpu's."""
    y0, x0, y1, x1 = boxes[:, 1], boxes[:, 0], boxes[:, 3], boxes[:, 2]
    inv = float(np.float32(1.0) / np.float32(out_size))   # as XLA divides
    side = torch.clamp(torch.stack([y1 - y0, x1 - x0], 1) * inv, min=1e-6)
    with fp32_math():
        return scale_and_translate(image, out_size, out_size, 1.0 / side,
                                   -torch.stack([y0, x0], 1) / side)
