"""HTML tokenization and link extraction.

Host-side analogue of the reference DOM walk (reference: parser/parser.go:49-158
`tokenize`, crawler/crawler.go:21-109 `EnqueueChildren`). The standard
library's html.parser drives a small tree builder (_TreeBuilder) that places
nodes the way libxml2's HTML parser does (implied html/head/body, the
auto-close rules that matter for text placement, stray end tags ignored,
nothing after </html>), so the DOM walk below sees the same text runs under
the same parents. One pass extracts:

- the page <title> (last one wins, trimmed),
- body words (text nodes whose parent is not title/script/style/noscript/iframe),
- meta description/keywords/author contents,
- anchor ("fancy") texts keyed by resolved+cleaned target URL,
- the ordered set of outgoing links (crawl frontier edges).

URL handling parity notes:
- skip empty/#/javascript/mailto hrefs, strip one trailing '/', skip media
  extensions, resolve relative hrefs against scheme://host or base+'/',
  drop spaces/newlines from the final URL. The reference's cleaning regex
  (crawler/crawler.go:25) is malformed (a '[]' inside the character class) and
  in practice only strips spaces and newlines — we reproduce that effective
  behavior directly.
- Deliberate deviation: the reference's anchor-text capture only fires when
  href is the *first* attribute of <a> (parser/parser.go:78-146 breaks out of
  the attribute loop after one iteration); we accept href anywhere, matching
  the crawler-side extractor (crawler/crawler.go:23-104).
"""

from __future__ import annotations

import codecs
import re
from dataclasses import dataclass, field
from html.parser import HTMLParser
from urllib.parse import urljoin

from ..config import MEDIA_EXTENSIONS

# Effective behavior of the reference's URL-cleaning regex: remove blanks.
_URL_WS = re.compile(r"\r?\n| ")

_SKIP_TEXT_PARENTS = frozenset(("title", "script", "style", "noscript", "iframe"))
_META_NAMES = frozenset(("description", "keywords", "author"))

# Tags whose entire subtree is excluded from summaries
# (reference: retrieval/get_metadata.go:96-115 prunes these elements' children).
_SUMMARY_PRUNE = _SKIP_TEXT_PARENTS | {"a", "nav"}


def clean_url(u: str) -> str:
    return _URL_WS.sub("", u)


from functools import lru_cache


@lru_cache(maxsize=1 << 12)
def _base_authority(base_url: str) -> str:
    """scheme://host[:port] of a base URL (one entry per crawled site)."""
    from urllib.parse import urlsplit

    p = urlsplit(base_url)
    return f"{p.scheme}://{p.netloc}"


@lru_cache(maxsize=1 << 16)
def resolve_href(href: str, base_url: str) -> str | None:
    """Resolve an <a href> into a cleaned absolute-ish URL, or None to skip.
    Cached: pages repeat hrefs (nav bars, footers) and urljoin measured
    ~20% of the tokenizer profile."""
    if not href or href[0] == "#" or href.startswith(("javascript", "mailto")):
        return None
    if href.endswith("/"):
        href = href[:-1]
    if not href:
        return None
    low = href.lower()
    for ext in MEDIA_EXTENSIONS:
        if low.endswith(ext):
            return None
    if len(href) < 4 or (href[:4] != "http" and href[:4] != "www."):
        # deliberate fixes vs the reference: (a) RFC-3986 resolution — the
        # reference appends base+"/"+href (crawler.go:82-83), which mangles
        # any base URL carrying a file segment (http://h/a.html + b.html ->
        # http://h/a.html/b.html); (b) keep the port (crawler.go:78 uses
        # Hostname(), which drops non-default ports and would break any
        # crawl of a :port site)
        if href[0] == "/" and not href.startswith("//") and "./" not in href:
            # root-relative with no dot segments: RFC resolution is just
            # scheme://authority + href — urljoin measured ~70 us per cache
            # miss, ~25% of the tokenizer profile on link-dense pages
            return clean_url(_base_authority(base_url) + href)
        return clean_url(urljoin(base_url, href))
    if href == base_url:
        return None
    return clean_url(href)


@dataclass
class TokenizedPage:
    title: str = ""
    words: list[str] = field(default_factory=list)
    meta: list[str] = field(default_factory=list)
    #: (resolved_url, trimmed_anchor_text) in document order
    fancy: list[tuple[str, str]] = field(default_factory=list)
    #: ordered unique outgoing links (resolved+cleaned)
    links: list[str] = field(default_factory=list)
    #: summary-visible words (a/nav/... subtrees pruned), extracted from the
    #: SAME parsed DOM so index time pays one lxml parse, not two
    summary: list[str] = field(default_factory=list)


class _Node:
    """A DOM element in lxml's shape: text before the first child in
    `text`, text after the element (inside its parent) in `tail`. Comments
    and processing instructions are nodes with tag None: they split the
    surrounding text like lxml's comment nodes and carry no text."""

    __slots__ = ("tag", "attrs", "text", "tail", "children")

    def __init__(self, tag: str | None, attrs: dict[str, str] | None = None):
        self.tag = tag
        self.attrs = attrs or {}
        self.text: str | None = None
        self.tail: str | None = None
        self.children: list[_Node] = []

    def get(self, name: str, default=None):
        return self.attrs.get(name, default)

    def __iter__(self):
        return iter(self.children)

    def __len__(self) -> int:
        return len(self.children)


_VOID = frozenset(
    "area base basefont br col embed frame hr img input isindex keygen link "
    "meta param source track wbr".split()
)
#: elements that stay in <head> while the body has not started
_HEAD_CONTENT = frozenset("title meta link script style base".split())
#: raw-text elements beyond html.parser's own script/style: their content
#: is one text run, never markup
_RAW_TEXT = frozenset("iframe noembed noframes xmp".split())
#: libxml2's htmlStartClose table: "old: new new ..." — an open `old` that
#: is the current node is closed when a `new` start tag arrives
_START_CLOSE_TABLE = """
a: a fieldset table td th
address: dd dl dt form li ul
b: center p td th
big: p
caption: col colgroup tbody tfoot thead tr
col: col colgroup tbody tfoot thead tr
colgroup: colgroup tbody tfoot thead tr
dd: dt
dir: dd dl dt form ul
dl: form li
dt: dd dl
font: center td th
form: form
h1: fieldset form li p table
h2: fieldset form li p table
h3: fieldset form li p table
h4: fieldset form li p table
h5: fieldset form li p table
h6: fieldset form li p table
hr: form
i: center p td th
legend: fieldset
li: li
listing: dd dl dt fieldset form li table ul
menu: dd dl dt form ul
ol: form
option: optgroup option
p: address blockquote body caption center col colgroup dd dir div dl dt
   fieldset form frameset h1 h2 h3 h4 h5 h6 head hr li listing menu ol p
   pre table tbody td tfoot th title tr ul xmp
pre: dd dl dt fieldset form li table ul
s: p
small: p
span: td th
strike: p
tbody: tbody tfoot
td: tbody td tfoot th tr
tfoot: tbody
th: tbody td tfoot th tr
thead: tbody tfoot
tr: tbody tfoot tr
tt: p
u: p td th
ul: address form menu ol pre
xmp: dd dl dt fieldset form li table ul
"""


def _start_close() -> dict[str, frozenset[str]]:
    closes: dict[str, set[str]] = {}
    for entry in re.split(r"\n(?=\S)", _START_CLOSE_TABLE.strip()):
        old, news = entry.split(":")
        for new in news.split():
            closes.setdefault(new, set()).add(old)
    return {k: frozenset(v) for k, v in closes.items()}


_AUTO_CLOSE = _start_close()

_FULL_HTML = re.compile(rb"^\s*<(?:html|!doctype)", re.I)
_CHARSET = re.compile(
    rb"""<meta[^>]*?charset\s*=\s*["']?\s*([A-Za-z0-9._:-]+)"""
    rb"""|<\?xml[^>]*?encoding\s*=\s*["']([A-Za-z0-9._:-]+)""",
    re.I,
)


def _decode(doc: bytes) -> str:
    """libxml2's choice of encoding: a BOM or a declared charset (meta
    charset, http-equiv content, XML declaration) when present, Latin-1
    otherwise."""
    if doc.startswith(codecs.BOM_UTF8):
        return doc[3:].decode("utf-8", "replace")
    m = _CHARSET.search(doc, 0, 4096)
    if m:
        name = (m.group(1) or m.group(2)).decode("ascii")
        try:
            return doc.decode(name, "replace")
        except LookupError:
            pass
    return doc.decode("latin-1")


class _TreeBuilder(HTMLParser):
    def __init__(self) -> None:
        super().__init__(convert_charrefs=True)
        self.root = _Node("html")
        self.head: _Node | None = None
        self.body: _Node | None = None
        self.stack: list[_Node] = [self.root]
        self.done = False  # past </html>: libxml2 keeps nothing more
        self.any = False  # saw any element, text, or comment
        self.opened = False  # the document element has started

    # -- placement --------------------------------------------------------
    def _append(self, node: _Node, push: bool) -> None:
        self.stack[-1].children.append(node)
        if push:
            self.stack.append(node)

    def _text(self, data: str) -> None:
        parent = self.stack[-1]
        if parent.children:
            last = parent.children[-1]
            last.tail = (last.tail or "") + data
        else:
            parent.text = (parent.text or "") + data

    def _leave_head(self) -> None:
        if self.head is not None and self.head in self.stack:
            del self.stack[self.stack.index(self.head):]

    def _ensure_body(self) -> None:
        if self.body is None:
            self._leave_head()
            del self.stack[1:]
            self.body = _Node("body")
            self._append(self.body, push=True)
        elif self.body not in self.stack:
            # content after </body> lands in <html>, after the body
            del self.stack[1:]

    # -- parser callbacks ---------------------------------------------------
    def handle_starttag(self, tag, attrs, self_closing=False) -> None:
        if self.done:
            return
        self.any = self.opened = True
        attrs = {k: ("" if v is None else v) for k, v in attrs}
        if tag == "html":
            for k, v in attrs.items():
                self.root.attrs.setdefault(k, v)
            return
        if tag == "head":
            if self.head is None and self.body is None:
                self.head = _Node("head", attrs)
                self._append(self.head, push=True)
            return
        if tag == "body":
            if self.body is None:
                self._leave_head()
                self.body = _Node("body", attrs)
                self._append(self.body, push=True)
            return
        if tag in _HEAD_CONTENT and self.body is None:
            if self.head is None:
                self.head = _Node("head")
                self._append(self.head, push=True)
            elif self.head not in self.stack:
                self.stack.append(self.head)
        else:
            self._ensure_body()
            closes = _AUTO_CLOSE.get(tag)
            while closes and len(self.stack) > 2 and self.stack[-1].tag in closes:
                self.stack.pop()
        push = tag not in _VOID and not self_closing
        self._append(_Node(tag, attrs), push=push)
        if push and tag in _RAW_TEXT:
            self.set_cdata_mode(tag)

    def handle_startendtag(self, tag, attrs) -> None:
        self.handle_starttag(tag, attrs, self_closing=True)

    def handle_endtag(self, tag) -> None:
        if self.done:
            return
        if tag == "html":
            self.done = self.opened  # a stray </html> before any content
            return
        for i in range(len(self.stack) - 1, 0, -1):
            if self.stack[i].tag == tag:
                del self.stack[i:]
                return
        # a stray end tag is ignored: the text around it stays one run

    def handle_data(self, data) -> None:
        if self.done:
            return
        self.any = True
        if data.strip():
            self.opened = True
        top = self.stack[-1]
        if self.body is None and top.tag in ("html", "head") and data.strip():
            self._ensure_body()  # text implies the body
        self._text(data)  # after </body>: lands in the body's tail

    def _split(self) -> None:
        if self.done:
            return
        self.any = True
        self._append(_Node(None), push=False)

    def handle_comment(self, data) -> None:
        self._split()

    def handle_pi(self, data) -> None:
        self._split()

    def unknown_decl(self, data) -> None:  # <![CDATA[...]]>: content dropped
        self._split()


def _parse_dom(doc: bytes | str):
    """Parse like lxml.html.fromstring: the <html> root for full documents
    and fragments with head content; otherwise the body, or its only
    element when the fragment was a single element."""
    if isinstance(doc, str):
        doc = doc.encode("utf-8", "replace")
    if not doc.strip():
        return None
    tb = _TreeBuilder()
    tb.feed(_decode(doc))
    tb.close()
    if not tb.any or (tb.body is None and tb.head is None and not tb.root.children):
        return None
    if _FULL_HTML.match(doc) or tb.head is not None or tb.body is None:
        return tb.root
    body = tb.body
    if (len(body) == 1 and not (body.text or "").strip()
            and not (body.children[-1].tail or "").strip()):
        return body.children[0]
    return body


def tokenize_page(
    doc: bytes | str, base_url: str, with_summary: bool = False
) -> TokenizedPage:
    page = TokenizedPage()
    root = _parse_dom(doc)
    if root is None:
        return page
    if with_summary:
        page.summary = extract_summary_text(None, root=root)
    seen_links: set[str] = set()

    def handle_text(parent, text: str) -> None:
        tag = parent.tag if isinstance(parent.tag, str) else ""
        cleaned = text.strip()
        if tag == "title":
            return
        if tag in _SKIP_TEXT_PARENTS or not cleaned:
            return
        if tag == "a":
            href = parent.get("href")
            if href is not None:
                resolved = resolve_href(href, base_url)
                if resolved:
                    page.fancy.append((resolved, cleaned))
        page.words.append(cleaned)

    def visit(el) -> None:
        if not isinstance(el.tag, str):  # comments / processing instructions
            return  # (tail text is handled by the parent's child loop)
        tag = el.tag
        if tag == "title":
            text = (el.text or "").strip()
            if el.text is not None:
                page.title = text
        elif tag == "meta":
            if el.get("name") in _META_NAMES:
                page.meta.append(el.get("content") or "")
        elif tag == "a":
            href = el.get("href")
            if href is not None:
                resolved = resolve_href(href, base_url)
                if resolved and resolved not in seen_links:
                    seen_links.add(resolved)
                    page.links.append(resolved)
        if el.text:
            handle_text(el, el.text)
        for child in el:
            visit(child)
            if child.tail:
                handle_text(el, child.tail)

    visit(root)
    return page


def extract_summary_text(doc: bytes | str | None, root=None) -> list[str]:
    """Visible words for summaries: prunes a/nav/title/script/... subtrees
    entirely, then splits on whitespace (reference: get_metadata.go:94-119).
    Pass `root` to reuse an already-parsed DOM."""
    if root is None:
        root = _parse_dom(doc)
    if root is None:
        return []
    pieces: list[str] = []

    def visit(el) -> None:
        if not isinstance(el.tag, str):
            return
        if el.tag in _SUMMARY_PRUNE:
            return
        if el.text and el.text.strip():
            pieces.append(el.text.strip())
        for child in el:
            visit(child)
            if child.tail and child.tail.strip():
                # tail text belongs to the parent element, which is not pruned
                pieces.append(child.tail.strip())

    visit(root)
    return " ".join(pieces).split()
