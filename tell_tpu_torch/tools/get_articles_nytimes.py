"""Scrape NYTimes articles through the Archive API into articles.jsonl
(counterpart of tools/get_articles_nytimes.py, step 1 of
docs/getting_data.md).

Walks the Archive API month by month, fetches each article page and
sections it with the port's extractor (serving/extractor.py's get_urls,
which also fetches each caption's image), and writes one JSON line per
article that has an image: the sections, each caption's image hash
(sha256 of its URL, 24 hex digits) and the image positions. With
--images-out each image is written there as <hash>.jpg, whatever its
format, and its base64 leaves the line. Needs network egress and an NYT
API key (https://developer.nytimes.com); host code only, no device.

    python -m tell_tpu_torch.tools.get_articles_nytimes --key KEY \
        --start 2010-01 --end 2018-12 --out articles.jsonl \
        [--images-out raw_images/] [--sleep 6] [--append]
"""
from __future__ import annotations

import argparse
import base64
import hashlib
import json
import os
import sys
import time

from ..serving.extractor import get_urls

ARCHIVE = ("https://api.nytimes.com/svc/archive/v1/{year}/{month}.json"
           "?api-key={key}")


def months(start: str, end: str):
    """(year, month) from `start` to `end` (YYYY-MM), both included."""
    y, m = map(int, start.split("-"))
    ye, me = map(int, end.split("-"))
    while (y, m) <= (ye, me):
        yield y, m
        m += 1
        if m > 12:
            y, m = y + 1, 1


def fetch_json(url: str) -> dict:
    from urllib.request import Request, urlopen
    req = Request(url, headers={"User-Agent": "Mozilla/5.0"})
    return json.loads(urlopen(req, timeout=30).read())


def image_hash(url: str) -> str:
    """A caption image's name in the dataset: sha256 of its URL, 24 hex
    digits."""
    return hashlib.sha256(url.encode()).hexdigest()[:24]


def article_record(meta: dict) -> dict | None:
    """Fetch and section one Archive API doc; None when unusable (no URL,
    a page that does not fetch or parse, no caption with an image URL)."""
    url = meta.get("web_url", "")
    if not url:
        return None
    try:
        out = get_urls(url)
    except Exception:
        return None
    sections = out["sections"]
    image_positions = []
    for i, sec in enumerate(sections):
        # a caption without an image URL is no image position (a hash of
        # the empty string would be shared by the whole corpus)
        if sec["type"] == "caption" and sec.get("url"):
            sec["hash"] = image_hash(sec["url"])
            image_positions.append(i)
    if not image_positions:
        return None
    return {
        "_id": meta.get("_id", url),
        "web_url": url,
        "headline": {"main": out["title"]},
        "pub_date": meta.get("pub_date", ""),
        "parsed_section": sections,
        "image_positions": image_positions,
    }


def save_images(rec: dict, images_out: str) -> None:
    """Move each image position's base64 out of `rec` into
    <images_out>/<hash>.jpg."""
    for i in rec["image_positions"]:
        sec = rec["parsed_section"][i]
        data = sec.pop("image_data", None)
        if data:
            with open(os.path.join(images_out, f"{sec['hash']}.jpg"),
                      "wb") as f:
                f.write(base64.b64decode(data))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--key", required=True)
    ap.add_argument("--start", required=True, help="YYYY-MM")
    ap.add_argument("--end", required=True, help="YYYY-MM")
    ap.add_argument("--out", required=True)
    ap.add_argument("--images-out", default=None,
                    help="also save the images as <hash>.jpg")
    ap.add_argument("--sleep", type=float, default=6.0,
                    help="seconds between months (the Archive API allows "
                    "10 requests a minute)")
    ap.add_argument("--append", action="store_true",
                    help="append to --out instead of overwriting it")
    args = ap.parse_args(argv)
    if args.images_out:
        os.makedirs(args.images_out, exist_ok=True)
    n = 0
    with open(args.out, "a" if args.append else "w",
              encoding="utf-8") as f:
        for year, month in months(args.start, args.end):
            docs = fetch_json(ARCHIVE.format(year=year, month=month,
                                             key=args.key))
            docs = docs.get("response", {}).get("docs", [])
            print(f"{year}-{month:02d}: {len(docs)} articles")
            for meta in docs:
                rec = article_record(meta)
                if rec is None:
                    continue
                if args.images_out:
                    save_images(rec, args.images_out)
                f.write(json.dumps(rec) + "\n")
                n += 1
            time.sleep(args.sleep)
    print(f"wrote {n} articles")
    return 0


if __name__ == "__main__":
    sys.exit(main())
