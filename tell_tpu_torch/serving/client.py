"""HTTP captioning client (a copy of tell_tpu/serving/client.py): the
reference client's parse(articles) surface with request ids, timeouts and
retries, over the caption service's HTTP API. parse() posts concurrently,
so the server's micro-batcher can put the articles in one decode.
"""
from __future__ import annotations

import json
import time
import urllib.error
import urllib.request


class ClientError(Exception):
    pass


class CaptioningClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 5558,
                 timeout: float = 120.0, retries: int = 2):
        self.base = f"http://{host}:{port}"
        self.timeout = timeout
        self.retries = retries
        self._req_id = 0

    def _post(self, path: str, payload: dict) -> dict:
        body = json.dumps(payload).encode("utf-8")
        last: Exception | None = None
        for attempt in range(self.retries + 1):
            try:
                req = urllib.request.Request(
                    self.base + path, data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req,
                                            timeout=self.timeout) as r:
                    return json.loads(r.read())
            except urllib.error.HTTPError as e:
                raise ClientError(f"{path}: {e.code} {e.read()[:200]!r}")
            except Exception as e:  # connection errors: retry
                last = e
                time.sleep(0.2 * (attempt + 1))
        raise ClientError(f"{path}: {last}")

    def status(self) -> dict:
        with urllib.request.urlopen(self.base + "/status",
                                    timeout=self.timeout) as r:
            return json.loads(r.read())

    def caption(self, article: dict) -> dict:
        """article: {context | sections+image_position, image_grid?, ...}."""
        self._req_id += 1
        return self._post("/caption", article)

    def parse(self, articles: list[dict]) -> list[dict]:
        """The reference client's batch entry (caption.py:9-19). Requests
        post CONCURRENTLY so the server's micro-batcher can coalesce them
        into one decode — serial posting would decode each article as a
        padded batch of one."""
        if len(articles) <= 1:
            return [self.caption(a) for a in articles]
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(len(articles), 32)) as ex:
            return list(ex.map(self.caption, articles))

    def scrape(self, url: str) -> dict:
        return self._post("/scrape", {"url": url})
