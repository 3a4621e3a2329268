"""Write the JPEG and PNG fixtures of tests/fixtures/images and their
manifest.

    python tests/fixtures/images/make_fixtures.py

Every image is drawn from a seeded numpy array and encoded by Pillow,
except the forms Pillow does not write: 4:1:1, 4:4:0 and YCCK JPEGs come
from `encode_sequential` below (a plain baseline encoder), and some PNGs
(2/4-bit grey, 16-bit colour, Adam7, each filter type, a palette with
tRNS, a bad CRC, a cut IDAT) from `write_png` (zlib + struct). The
manifest holds, for each file Pillow decodes, the sha256 of
np.asarray(Image.open(f).convert("RGB")) and of its 224 crop (tell_tpu's
resize_shortest_crop); for each refused one the form the port must name
("refused", a NotPortedError) or the words of its corrupt-data error
("corrupt", a ValueError; Pillow raises too); and for the news photos'
twins the baseline file whose decode they equal ("twin_of"). For the news
photos, their twins and one odd size, `processed` names the file under
processed/ that tell_tpu's tools/process_images.py writes for the photo
as a .jpg (Pillow's JPEG at its defaults) and its sha256. Needs Pillow (a
test dependency; the port itself has none).
"""
import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))


def photo(h, w, seed):
    """A smooth scene with edges and grain, like a downscaled photo."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([
        128 + 90 * np.sin(xx / (w / 5.0) + yy / (h / 3.0)),
        128 + 80 * np.cos(xx / (w / 7.0)) * np.sin(yy / (h / 4.0)),
        128 + 70 * np.sin((xx + yy) / (w / 3.0))], -1)
    for _ in range(6):   # a few flat boxes: hard edges for the IDCT
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        img[y0:y0 + h // 4, x0:x0 + w // 5] = rng.integers(0, 256, 3)
    img += rng.normal(0, 8, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def noise(h, w, seed, channels=3):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    return a[..., 0] if channels == 1 else a


def encode(arr, **kw):
    f = io.BytesIO()
    Image.fromarray(arr).save(f, "JPEG", **kw)
    return f.getvalue()


def patch_sampling(data, luma):
    """The same file with the luma sampling byte of its SOF0 set to
    `luma` (0x41: 4:1:1, 0x12: 4:4:0) -- a header the decoder must refuse
    before it reads any scan."""
    b = bytearray(data)
    i = b.index(b"\xff\xc0")
    b[i + 11] = luma
    return bytes(b)


def patch_precision(data, bits):
    b = bytearray(data)
    b[b.index(b"\xff\xc0") + 4] = bits
    return bytes(b)


# --- a plain sequential JPEG encoder, for the samplings and colour spaces
# Pillow does not write -------------------------------------------------

ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19,
          26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49,
          56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45,
          38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                             for s in range(1, 11)]


def _dct_matrix():
    c = np.array([[np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                  for u in range(8)])
    c[0] /= np.sqrt(2)
    return c / 2


def encode_sequential(planes, sampling, ids=(1, 2, 3), adobe=None,
                      jfif=True, restart=0):
    """A baseline JPEG of the full-resolution uint8 planes [n][H, W] at
    per-component sampling factors [(h, v)] (each plane box-averaged to
    its factor), one quantiser table, fixed-length Huffman codes (4 bits
    for DC sizes, 8 for AC symbols), an optional Adobe APP14 transform
    byte and restart interval (in MCUs)."""
    H, W = planes[0].shape
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    q = np.array([[2 + 2 * (u + v) for v in range(8)] for u in range(8)])
    C = _dct_matrix()
    comps = []
    for plane, (h, v) in zip(planes, sampling):
        rh, rv = hmax // h, vmax // v
        ph, pw = mcuy * vmax * 8, mcux * hmax * 8
        full = np.pad(plane.astype(np.float64),
                      ((0, ph - H), (0, pw - W)), mode="edge")
        sub = full.reshape(ph // rv, rv, pw // rh, rh).mean((1, 3))
        blocks = sub.reshape(ph // rv // 8, 8, pw // rh // 8, 8)
        coef = np.einsum("ux,axby,vy->abuv", C, blocks - 128.0, C)
        comps.append(np.round(coef / q).astype(np.int64)
                     .reshape(*coef.shape[:2], 64)[..., ZIGZAG])
    out = bytearray()
    acc, nacc = 0, 0

    def bits(value, n):
        nonlocal acc, nacc
        acc, nacc = (acc << n) | (value & ((1 << n) - 1)), nacc + n
        while nacc >= 8:
            byte = (acc >> (nacc - 8)) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
            nacc -= 8

    def flush():
        nonlocal nacc
        if nacc:
            bits((1 << (8 - nacc)) - 1, 8 - nacc)

    def category(x):
        n = int(abs(x)).bit_length()
        return n, (x if x >= 0 else x + (1 << n) - 1)

    preds = [0] * len(planes)
    count = 0
    rst = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart and count and count % restart == 0:
                flush()
                out += bytes([0xFF, 0xD0 + rst])
                rst, preds = (rst + 1) & 7, [0] * len(planes)
            count += 1
            for ci, (h, v) in enumerate(sampling):
                for by in range(v):
                    for bx in range(h):
                        blk = comps[ci][my * v + by, mx * h + bx]
                        n, b = category(blk[0] - preds[ci])
                        preds[ci] = blk[0]
                        bits(n, 4)
                        bits(b, n)
                        run = 0
                        for k in range(1, 64):
                            if blk[k] == 0:
                                run += 1
                                continue
                            while run > 15:
                                bits(AC_SYMBOLS.index(0xF0), 8)
                                run -= 16
                            n, b = category(blk[k])
                            bits(AC_SYMBOLS.index((run << 4) | n), 8)
                            bits(b, n)
                            run = 0
                        if run:
                            bits(0, 8)     # EOB, symbol 0x00
    flush()

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    n = len(planes)
    head = b"\xff\xd8"
    if jfif:
        head += seg(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        head += seg(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, adobe]))
    head += seg(0xDB, b"\x00" + bytes(int(x) for x in q.reshape(-1)[ZIGZAG]))
    head += seg(0xC0, struct.pack(">BHHB", 8, H, W, n) + b"".join(
        bytes([ids[i], (sampling[i][0] << 4) | sampling[i][1], 0])
        for i in range(n)))
    dc_counts = bytes([0, 0, 0, 12] + [0] * 12)
    ac_counts = bytes([0] * 7 + [len(AC_SYMBOLS)] + [0] * 8)
    head += seg(0xC4, b"\x00" + dc_counts + bytes(range(12))
                + b"\x10" + ac_counts + bytes(AC_SYMBOLS))
    if restart:
        head += seg(0xDD, struct.pack(">H", restart))
    head += seg(0xDA, bytes([n]) + b"".join(bytes([ids[i], 0x00])
                                             for i in range(n))
                + b"\x00\x3f\x00")
    return head + bytes(out) + b"\xff\xd9"


def ycbcr_planes(rgb):
    """JFIF's RGB -> YCbCr, rounded to uint8 planes."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128 + 0.5 * r - 0.418688 * g - 0.081312 * b
    return [np.clip(np.round(p), 0, 255).astype(np.uint8)
            for p in (y, cb, cr)]


def drop_last_scans(data, n):
    """A progressive file without its last n scans (each SOS up to the next
    marker that is not a restart): its last coefficients stay unrefined,
    and libjpeg smooths the blocks."""
    sos = [i for i in range(len(data) - 1)
           if data[i] == 0xFF and data[i + 1] == 0xDA]
    cut = sos[-n]
    return data[:cut] + b"\xff\xd9"


# --- PNGs --------------------------------------------------------------

def png_chunk(cid, body):
    return (struct.pack(">I", len(body)) + cid + body
            + struct.pack(">I", zlib.crc32(cid + body) & 0xFFFFFFFF))


def _filter_row(row, prev, ftype, bpp):
    """PNG's filter `ftype` applied to one scanline (numpy uint8)."""
    row, prev = row.astype(np.int64), prev.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
    if ftype == 0:
        pred = 0
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = prev
    elif ftype == 3:
        pred = (a + prev) // 2
    else:
        p = a + prev - c
        pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
    return ((row - pred) & 0xFF).astype(np.uint8)


def _pack_rows(samples, depth):
    """uint [h, w*channels] samples -> packed big-endian scanlines."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    h, n = samples.shape
    padded = np.zeros((h, -(-n // per) * per), np.uint8)
    padded[:, :n] = samples
    shifts = np.array([8 - depth * (i + 1) for i in range(per)], np.uint8)
    return (padded.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def write_png(samples, depth, color_type, palette=None, trns=None,
              interlace=False, filters=(0,), chunks_edit=None):
    """A PNG of uint samples [H, W, channels] at `depth`: scanline filter
    types taken in turn from `filters`, Adam7 when `interlace`."""
    H, W, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ([(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
               (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)] if interlace
              else [(0, 0, 1, 1)])
    raw, k = bytearray(), 0
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack_rows(sub.reshape(sub.shape[0], -1), depth)
        prev = np.zeros(rows.shape[1], np.uint8)
        for row in rows:
            ftype = filters[k % len(filters)]
            k += 1
            raw.append(ftype)
            raw += _filter_row(row, prev, ftype, bpp).tobytes()
            prev = row
    body = [(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color_type, 0, 0,
                                  int(interlace)))]
    if palette is not None:
        body.append((b"PLTE", bytes(palette)))
    if trns is not None:
        body.append((b"tRNS", bytes(trns)))
    body += [(b"IDAT", zlib.compress(bytes(raw), 9)), (b"IEND", b"")]
    out = b"\x89PNG\r\n\x1a\n" + b"".join(png_chunk(c, b) for c, b in body)
    return chunks_edit(out) if chunks_edit else out


def pillow_png(img):
    """Pillow's PNG of an array or an Image."""
    f = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(
        f, "PNG")
    return f.getvalue()


def bad_crc(data):
    """The IHDR chunk's CRC flipped: Pillow checks the chunks before IDAT."""
    b = bytearray(data)
    b[8 + 8 + 13] ^= 0xFF
    return bytes(b)


def cut_idat(data):
    """The IDAT chunk's zlib stream cut to half, with a valid chunk around
    it (Pillow: image file is truncated)."""
    i = data.index(b"IDAT") - 4
    n = struct.unpack(">I", data[i:i + 4])[0]
    z = data[i + 8:i + 8 + n][: n // 2]
    return data[:i] + png_chunk(b"IDAT", z) + png_chunk(b"IEND", b"")


def new_files(news):
    """The files added to the baseline set: {name: bytes}, refused
    {name: (bytes, key, words)} and twins {name: baseline name}."""
    files, refused, twins = {}, {}, {}
    # progressive twins of the news photos: Pillow's progressive script
    # over the same coefficients, so they decode to the baseline's bytes
    for name, (arr, q) in news.items():
        twin = name.replace("_420.jpg", "_420_progressive.jpg")
        files[twin] = encode(arr, quality=q, progressive=True)
        twins[twin] = name
        # PNG twins: news_a's of the baseline's decoded pixels (the same
        # bytes), news_b's of the seeded source array (different bytes)
        png = name.replace(".jpg", ".png")
        if name.startswith("news_a"):
            rgb = np.asarray(Image.open(io.BytesIO(encode(arr, quality=q)))
                             .convert("RGB"))
            files[png] = pillow_png(rgb)
            twins[png] = name
        else:
            files[png] = pillow_png(arr)
    files.update({
        "prog_101x67_444.jpg": encode(photo(67, 101, 20), quality=90,
                                      subsampling=0, progressive=True),
        "prog_67x101_422.jpg": encode(photo(101, 67, 21), quality=60,
                                      subsampling=1, progressive=True),
        "prog_9x7_420.jpg": encode(noise(7, 9, 22), quality=75,
                                   progressive=True),
        "prog_grey_67x101.jpg": encode(photo(101, 67, 23)[..., 0],
                                       quality=80, progressive=True),
        "prog_restart_101x67_422.jpg": encode(
            photo(67, 101, 24), quality=75, subsampling=1, progressive=True,
            restart_marker_blocks=3),
        "prog_restart_rows_67x101_444.jpg": encode(
            photo(101, 67, 25), quality=85, subsampling=0, progressive=True,
            restart_marker_rows=1),
        "cmyk_48x40.jpg": _cmyk(photo(40, 48, 26)),
        "cmyk_prog_33x21.jpg": _cmyk(photo(21, 33, 27), progressive=True),
        "rgbcoded_101x67.jpg": encode(photo(67, 101, 28), quality=85,
                                      keep_rgb=True),
        "sampling_411_101x67.jpg": encode_sequential(
            ycbcr_planes(photo(67, 101, 29)), [(4, 1), (1, 1), (1, 1)]),
        "sampling_440_67x101.jpg": encode_sequential(
            ycbcr_planes(photo(101, 67, 30)), [(1, 2), (1, 1), (1, 1)],
            restart=5),
        "sampling_411_9x7.jpg": encode_sequential(
            ycbcr_planes(noise(7, 9, 31)), [(4, 1), (1, 1), (1, 1)]),
        "ycck_420_45x37.jpg": encode_sequential(
            ycbcr_planes(photo(37, 45, 32))
            + [noise(37, 45, 33, channels=1)],
            [(2, 2), (1, 1), (1, 1), (2, 2)], ids=(1, 2, 3, 4), adobe=2,
            jfif=False),
        "rgbids_41x23.jpg": encode_sequential(
            [c for c in np.moveaxis(photo(23, 41, 34), -1, 0)],
            [(1, 1)] * 3, ids=(82, 71, 66), jfif=False),
    })
    rng = np.random.default_rng(35)
    grey = rng.integers(0, 256, (19, 23, 1))
    rgb = photo(19, 23, 36)
    files.update({
        "png_1bit_23x19.png": pillow_png(noise(19, 23, 37, channels=1) > 127),
        "png_L_23x19.png": pillow_png(grey[..., 0].astype(np.uint8)),
        "png_LA_23x19.png": pillow_png(
            np.dstack([grey[..., 0], noise(19, 23, 38, channels=1)]).astype(np.uint8)),
        "png_RGB_23x19.png": pillow_png(rgb),
        "png_RGBA_23x19.png": pillow_png(np.dstack([rgb, noise(19, 23, 39, channels=1)])
                                         .astype(np.uint8)),
        "png_I16_23x19.png": write_png(
            rng.integers(0, 1200, (19, 23, 1)), 16, 0, filters=(1, 4)),
        "png_P2_23x19.png": pillow_png(Image.fromarray(rgb).quantize(2)),
        "png_P4_23x19.png": pillow_png(Image.fromarray(rgb).quantize(4)),
        "png_P16_23x19.png": pillow_png(Image.fromarray(rgb).quantize(16)),
        "png_P256_23x19.png": pillow_png(Image.fromarray(rgb).quantize(256)),
        "png_grey2_23x19.png": write_png(
            rng.integers(0, 4, (19, 23, 1)), 2, 0, filters=(0, 1, 2)),
        "png_grey4_23x19.png": write_png(
            rng.integers(0, 16, (19, 23, 1)), 4, 0, filters=(3, 4)),
        "png_rgb16_23x19.png": write_png(
            rng.integers(0, 65536, (19, 23, 3)), 16, 2,
            filters=(0, 1, 2, 3, 4)),
        "png_la16_23x19.png": write_png(
            rng.integers(0, 65536, (19, 23, 2)), 16, 4, filters=(2, 4)),
        "png_rgba16_23x19.png": write_png(
            rng.integers(0, 65536, (19, 23, 4)), 16, 6, filters=(4, 3)),
        "png_filters_rgb_37x29.png": write_png(
            photo(29, 37, 40), 8, 2, filters=(0, 1, 2, 3, 4)),
        "png_adam7_rgb_37x29.png": write_png(
            photo(29, 37, 41), 8, 2, interlace=True, filters=(4, 1, 3)),
        "png_adam7_grey1_13x11.png": write_png(
            rng.integers(0, 2, (11, 13, 1)), 1, 0, interlace=True,
            filters=(0, 2)),
        "png_adam7_pal4_5x3.png": write_png(
            rng.integers(0, 16, (3, 5, 1)), 4, 3,
            palette=rng.integers(0, 256, 48), interlace=True),
        "png_pal_trns_23x19.png": write_png(
            rng.integers(0, 6, (19, 23, 1)), 8, 3,
            palette=rng.integers(0, 256, 15), trns=[0, 128, 255],
            filters=(1, 2)),
    })
    refused.update({
        "refused_progressive_unrefined.jpg": (
            drop_last_scans(encode(photo(40, 48, 42), quality=75,
                                   progressive=True), 3),
            "refused", "progressive"),
        "corrupt_png_crc.png": (bad_crc(pillow_png(rgb)), "corrupt",
                                "bad header checksum"),
        "corrupt_png_cut_idat.png": (cut_idat(pillow_png(rgb)), "corrupt",
                                     "truncated"),
    })
    return files, refused, twins


# the sources of processed/: the news photos, their twins and one odd size
PROCESSED = ("news_a_320x240_420.jpg", "news_a_320x240_420_progressive.jpg",
             "news_a_320x240_420.png", "news_b_200x300_420.jpg",
             "news_b_200x300_420_progressive.jpg", "news_b_200x300_420.png",
             "rgb_67x101_422.jpg")


def processed_name(name):
    """processed/'s file for the source `name` (a .png source's gets
    _png)."""
    stem, ext = os.path.splitext(name)
    return f"processed/{stem}{'_png' if ext == '.png' else ''}.jpg"


def write_processed(manifest):
    """tell_tpu's process_image over each PROCESSED source, written as a
    .jpg under processed/, its digest in the source's manifest entry."""
    from tools.process_images import process_image
    os.makedirs(os.path.join(HERE, "processed"), exist_ok=True)
    for name in PROCESSED:
        rel = processed_name(name)
        dst = os.path.join(HERE, rel)
        assert process_image(os.path.join(HERE, name), dst)
        with open(dst, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        manifest[name]["processed"] = {"file": rel, "sha256": digest}


def _cmyk(rgb, **kw):
    f = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(f, "JPEG", quality=85, **kw)
    return f.getvalue()


def main():
    sys.path.insert(0, ROOT)
    from tell_tpu.data.images import resize_shortest_crop

    files = {
        "news_a_320x240_420.jpg": encode(photo(240, 320, 1), quality=85),
        "news_b_200x300_420.jpg": encode(photo(300, 200, 2), quality=85),
        "rgb_1x1_420.jpg": encode(noise(1, 1, 3), quality=75),
        "rgb_9x7_422.jpg": encode(noise(7, 9, 4), quality=75, subsampling=1),
        "rgb_101x67_444.jpg": encode(photo(67, 101, 5), quality=95,
                                     subsampling=0),
        "rgb_67x101_422.jpg": encode(photo(101, 67, 6), quality=50,
                                     subsampling=1),
        "rgb_101x67_420.jpg": encode(photo(67, 101, 7), quality=75,
                                     subsampling=2),
        "grey_9x7.jpg": encode(noise(7, 9, 8, channels=1), quality=75),
        "grey_67x101.jpg": encode(photo(101, 67, 9)[..., 1], quality=90),
        "restart_101x67_420.jpg": encode(photo(67, 101, 10), quality=75,
                                         restart_marker_blocks=2),
        "restart_rows_67x101_444.jpg": encode(photo(101, 67, 11),
                                              quality=90, subsampling=0,
                                              restart_marker_rows=1),
    }
    # the first refused files keep their names and bytes; all but the 12-bit
    # one now decode (the 4:1:1 and 4:4:0 ones are a 4:4:4 scan read under
    # a patched header: Pillow decodes them too, to other pixels)
    base = encode(photo(40, 48, 12), quality=75, subsampling=0)
    files["refused_progressive.jpg"] = encode(photo(40, 48, 13), quality=75,
                                              progressive=True)
    files["refused_411.jpg"] = patch_sampling(base, 0x41)
    files["refused_440.jpg"] = patch_sampling(base, 0x12)
    f = io.BytesIO()
    Image.fromarray(photo(40, 48, 14)).convert("CMYK").save(f, "JPEG")
    files["refused_cmyk.jpg"] = f.getvalue()
    refused = {"refused_12bit.jpg": (patch_precision(base, 12), "refused",
                                     "12-bit")}
    added, more_refused, twins = new_files({
        "news_a_320x240_420.jpg": (photo(240, 320, 1), 85),
        "news_b_200x300_420.jpg": (photo(300, 200, 2), 85)})
    files.update(added)
    refused.update(more_refused)

    manifest = {}
    for name, data in files.items():
        with open(os.path.join(HERE, name), "wb") as out:
            out.write(data)
        im = Image.open(io.BytesIO(data)).convert("RGB")
        rgb = np.asarray(im)
        crop = np.asarray(resize_shortest_crop(im))
        manifest[name] = {
            "shape": list(rgb.shape),
            "rgb_sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
            "crop_sha256": hashlib.sha256(crop.tobytes()).hexdigest()}
        if name in twins:
            manifest[name]["twin_of"] = twins[name]
    for name, (data, key, words) in refused.items():
        with open(os.path.join(HERE, name), "wb") as out:
            out.write(data)
        manifest[name] = {key: words}
    write_processed(manifest)
    with open(os.path.join(HERE, "manifest.json"), "w") as out:
        json.dump(manifest, out, indent=1, sort_keys=True)
        out.write("\n")


if __name__ == "__main__":
    main()
