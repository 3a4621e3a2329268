"""Resize and centre-crop article images to 224 x 224 (counterpart of
tools/process_images.py, step 2 of docs/getting_data.md).

Each file of --images, in sorted order, is decoded by the port's decoders
(data/images.py's decode_image: JPEG and PNG), its shortest side resized
to 256 with Pillow's LANCZOS and its centre 224 cut (resize_shortest_crop,
equal to tell_tpu's byte for byte), and written under the same name in
--out, in the format its extension names, as tell_tpu's Image.save picks
it: `.jpg`, `.jpeg`, `.jpe` and `.jfif` through the port's JPEG encoder
(data/jpeg.py's encode_jpeg, equal to Pillow's file at its defaults byte
for byte, the source's comment carried over as Pillow carries it), `.png`
and `.apng` through data/png.py's encode_png (the same pixels). A file
that does not decode counts as failed, and its reason goes to stderr; a
format the port does not decode (GIF, WebP, BMP, TIFF, the JPEG forms
data/jpeg.py refuses) is such a failure, where tell_tpu opens it with
Pillow. Any other output extension raises a NotPortedError (a
ValueError) and stops the tool, as tell_tpu's save does for one Pillow
does not know; tell_tpu writes the formats Pillow knows (GIF, BMP,
TIFF, WebP, ...). Host code only, no device.

    python -m tell_tpu_torch.tools.process_images --images raw_images/ \
        --out images/
"""
from __future__ import annotations

import argparse
import os
import sys

from ..config import NotPortedError
from ..data.images import decode_image, image_comment, resize_shortest_crop
from ..data.jpeg import encode_jpeg
from ..data.png import encode_png

JPEG_EXTENSIONS = (".jpg", ".jpeg", ".jpe", ".jfif")
PNG_EXTENSIONS = (".png", ".apng")


def encoder_for(path: str):
    """The writer the extension of `path` names: encode_jpeg or
    encode_png; any other extension raises (a NotPortedError, a
    ValueError), as tell_tpu's Image.save does for one Pillow does not
    know."""
    ext = os.path.splitext(path)[1].lower()
    if ext in JPEG_EXTENSIONS:
        return encode_jpeg
    if ext in PNG_EXTENSIONS:
        return lambda rgb, comment=None: encode_png(rgb)
    known = " ".join(JPEG_EXTENSIONS + PNG_EXTENSIONS)
    raise NotPortedError(f"{path}: the port writes JPEG and PNG only "
                         f"({known}), not {ext!r} (ROADMAP queue 1 item 8)")


def process_image(src: str, dst: str, resize: int = 256,
                  crop: int = 224) -> bool:
    """Decode `src`, resize and crop it, write `dst`; False (and the
    reason on stderr) when `src` does not decode."""
    try:
        with open(src, "rb") as f:
            data = f.read()
        img = decode_image(data)
    except Exception as e:
        print(f"failed {src}: {type(e).__name__}: {e}", file=sys.stderr)
        return False
    out = resize_shortest_crop(img, resize, crop)
    blob = encoder_for(dst)(out, image_comment(data))
    with open(dst, "wb") as f:
        f.write(blob)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", required=True, help="raw image dir")
    ap.add_argument("--out", required=True, help="processed image dir")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    n_ok = n_bad = 0
    for name in sorted(os.listdir(args.images)):
        ok = process_image(os.path.join(args.images, name),
                           os.path.join(args.out, name))
        n_ok += ok
        n_bad += not ok
    print(f"processed {n_ok} images ({n_bad} failed)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
