"""NYT article scraping and sectioning for the /scrape route (counterpart of
tell_tpu/serving/extractor.py): fetch an article URL, extract the title and
the paragraph/caption sections of both NYT layouts (the post-2019
StoryBodyCompanionColumn one and the older story-body-text one), base64
the images, and package the request the captioner takes. Fetches happen in
get_urls only, so the parsing (extract_text) is testable offline.

tell_tpu parses with bs4; this module walks the HTML with the standard
library's html.parser into a small tree built by bs4's rules for that
parser (void elements close at once, an end tag closes up to its most
recent open match and is dropped when there is none, a node's text is
its strings but comments, script and style), so extract_text returns
tell_tpu's sections and title for the same HTML. Character references
are resolved by html.parser (convert_charrefs).
"""
from __future__ import annotations

import base64
from html.parser import HTMLParser

VOID = frozenset((
    "area", "base", "br", "col", "embed", "hr", "img", "input", "keygen",
    "link", "menuitem", "meta", "param", "source", "track", "wbr",
    "basefont", "bgsound", "command", "frame", "image", "isindex",
    "nextid", "spacer"))
_HIDDEN = frozenset(("script", "style", "template"))   # text not in .text


class ExtractError(Exception):
    pass


class Node:
    """An element: its name, attributes (class split into a list), parent
    and children (Nodes and str)."""

    __slots__ = ("name", "attrs", "parent", "children")

    def __init__(self, name: str, attrs: dict, parent: "Node | None"):
        self.name, self.attrs, self.parent = name, attrs, parent
        self.children: list = []

    def get(self, key: str, default=None):
        return self.attrs.get(key, default)

    @property
    def descendants(self):
        for c in self.children:
            yield c
            if isinstance(c, Node):
                yield from c.descendants

    @property
    def parents(self):
        p = self.parent
        while p is not None:
            yield p
            p = p.parent

    def find_all(self, names, cls: str | None = None) -> list["Node"]:
        names = {names} if isinstance(names, str) else set(names)
        return [d for d in self.descendants
                if isinstance(d, Node) and d.name in names
                and (cls is None or cls in (d.get("class") or []))]

    def find(self, name: str) -> "Node | None":
        return next(iter(self.find_all(name)), None)

    @property
    def text(self) -> str:
        return "".join(self._strings())

    def _strings(self):
        for c in self.children:
            if isinstance(c, Node):
                if c.name not in _HIDDEN:
                    yield from c._strings()
            else:
                yield c


class _DomParser(HTMLParser):
    def __init__(self):
        super().__init__(convert_charrefs=True)
        self.root = Node("[document]", {}, None)
        self.open = [self.root]

    def handle_starttag(self, tag, attrs):
        d = {}
        for k, v in attrs:
            v = "" if v is None else v
            d[k] = v.split() if k == "class" else v
        node = Node(tag, d, self.open[-1])
        self.open[-1].children.append(node)
        if tag not in VOID:
            self.open.append(node)

    def handle_startendtag(self, tag, attrs):
        self.handle_starttag(tag, attrs)
        if tag not in VOID:
            self.open.pop()

    def handle_endtag(self, tag):
        for i in range(len(self.open) - 1, 0, -1):
            if self.open[i].name == tag:
                del self.open[i:]
                return

    def handle_data(self, data):
        self.open[-1].children.append(data)


def parse_html(html: str) -> Node:
    p = _DomParser()
    p.feed(html)
    p.close()
    return p.root


def _check_fetchable(url: str, require_nyt: bool = False) -> None:
    """SSRF guard: http(s) only, and article URLs on nytimes.com, so that
    /scrape is not an open proxy that fetches file:// or internal URLs and
    hands back their bytes."""
    from urllib.parse import urlparse
    p = urlparse(url)
    if p.scheme not in ("http", "https"):
        raise ExtractError(f"unsupported URL scheme {p.scheme!r}")
    host = (p.hostname or "").lower()
    if require_nyt and not (host == "nytimes.com"
                            or host.endswith(".nytimes.com")):
        raise ExtractError("Only nytimes.com article URLs are supported.")


def get_urls(url: str) -> dict:
    """Fetch and parse an article URL (needs network egress): its sections
    (captions carry their image base64 in image_data), title and image
    URLs."""
    from urllib.request import Request, urlopen
    _check_fetchable(url, require_nyt=True)
    req = Request(url, headers={"User-Agent": "Mozilla/5.0"})
    raw_html = urlopen(req, timeout=10).read().decode("utf-8")
    try:
        parsed_sections, title = extract_text(raw_html)
    except ExtractError:
        raise
    except Exception:
        raise ExtractError("Error parsing the article. Pick another URL.")
    if not parsed_sections:
        raise ExtractError("No article text is found. Pick another URL.")
    image_urls = []
    for section in parsed_sections:
        if section["type"] == "caption" and section.get("url"):
            _check_fetchable(section["url"])
            img = urlopen(Request(section["url"],
                                  headers={"User-Agent": "Mozilla/5.0"}),
                          timeout=10).read()
            section["image_data"] = base64.b64encode(img).decode("utf-8")
            image_urls.append(section["url"])
    if not image_urls:
        raise ExtractError("No image is found in the article. "
                           "Pick another URL.")
    return {"sections": parsed_sections, "title": title,
            "image_urls": image_urls}


def extract_article(sections: list[dict], title: str,
                    selected_pos: int = 0) -> dict:
    """The captioning request for the selected_pos-th image."""
    positions = [i for i, s in enumerate(sections)
                 if s["type"] == "caption"]
    if not positions:
        raise ExtractError("No image in the parsed sections.")
    pos = positions[selected_pos]
    return {"sections": sections, "image_position": pos, "title": title,
            "true_caption": sections[pos].get("text", ""),
            "image_url": sections[pos].get("url", "")}


def extract_text(html: str) -> tuple[list[dict], str]:
    """Raw NYT article HTML -> (sections, title)."""
    soup = parse_html(html)
    h1 = soup.find("h1")
    if h1 is None:
        raise ExtractError("No headline found.")
    title = h1.text.strip()
    article = soup.find("article")
    if article is not None and article.find_all(
            "div", "StoryBodyCompanionColumn"):
        return _extract_new(article), title
    if soup.find_all("p", "story-body-text"):
        return _extract_old(soup), title
    return [], title


def _image_section(fig: Node) -> dict | None:
    img = fig.find("img")
    cap = fig.find("figcaption")
    if img is None or not img.get("src"):
        return None
    text = cap.text.strip() if cap is not None else ""
    return {"type": "caption", "text": text, "url": img.get("src")}


def _extract_new(article: Node) -> list[dict]:
    """Post-2019 layout: paragraphs inside StoryBodyCompanionColumn divs,
    figures interleaved in the article node (each image once)."""
    sections: list[dict] = []
    for node in article.descendants:
        if not isinstance(node, Node):
            continue
        if node.name == "figure":
            sec = _image_section(node)
            if sec is not None and not any(
                    s["type"] == "caption" and s.get("url") == sec["url"]
                    for s in sections):
                sections.append(sec)
        elif node.name == "p" and any(
                "StoryBodyCompanionColumn" in (a.get("class") or [])
                for a in node.parents):
            text = node.text.strip()
            if text:
                sections.append({"type": "paragraph", "text": text})
    return sections


def _extract_old(soup: Node) -> list[dict]:
    """Pre-2019 layout: p.story-body-text paragraphs and figures."""
    sections: list[dict] = []
    for node in soup.find_all(("p", "figure")):
        if node.name == "p" and "story-body-text" in (node.get("class")
                                                      or []):
            text = node.text.strip()
            if text:
                sections.append({"type": "paragraph", "text": text})
        elif node.name == "figure":
            sec = _image_section(node)
            if sec is not None:
                sections.append(sec)
    return sections
