"""HTML documents whose token streams tests/data/htmlparse_golden.json
records (tests/test_htmlparse.py): well-formed pages, the shapes the test
corpora and the benchmark corpus generate, and malformed markup."""

from __future__ import annotations

BASE = "http://site.local/dir/page.html"

SAMPLES: dict[str, str] = {
    "department": """
<html><head>
<title>  Department of Computing </title>
<meta name="description" content="Computer science research and education">
<meta name="keywords" content="algorithms, systems">
<meta name="robots" content="noindex">
</head>
<body>
<h1>Welcome to the Department</h1>
<script>var x = "ignore me";</script>
<style>.c { color: red }</style>
<noscript>enable scripts</noscript>
<p>We study search engines and ranked retrieval.</p>
<a href="/research">Our research directions</a>
<a href="http://example.com/people/">People pages</a>
<a href="#top">Top anchor</a>
<a href="mailto:x@y.z">mail</a>
<a href="javascript:void(0)">js</a>
<a href="files/report.PDF">media link</a>
<nav><a href="/nav-only">Navigation entry</a></nav>
</body></html>
""",
    "corpus_page": (
        "<html><head><title>chemistry novel</title></head>\n<body><h1>Page 3"
        "</h1>\n<p>node engine batch novel replica stream orbit query neural "
        "index</p>\n<a href=\"/page7\">quantum physics</a>\n</body></html>"
    ),
    "bench_page": (
        "<html><head><title>w00012 w00345</title></head><body><p>w00001 "
        "w00002 w00003 w00002</p>\n<a href=\"/p9\">w00002</a>\n<a href=\"/p1\">"
        "w00003</a>\n</body></html>"
    ),
    "nested_anchor": (
        "<html><body><a href='/x'>outer <b>bold</b> tail <i>it</i></a>"
        "after</body></html>"
    ),
    "unclosed": "<p>unclosed <b>bold <a href=/u>link text<p>next para",
    "comments": (
        "<html><body><p>before<!-- a comment -->after</p><!-- top -->"
        "<a href='/c'>one<!-- in anchor -->two</a></body></html>"
    ),
    "entities": (
        "<html><head><title>Fish &amp; Chips &lt;3</title></head><body>"
        "<p>caf&eacute; &#169; &#x41;BC &nbsp;spaced</p></body></html>"
    ),
    "script_tricks": (
        "<html><head><script>if (a < b && c > d) { s = '<p>no</p>'; }</script>"
        "</head><body><p>visible</p><style>p > a { x: y }</style>"
        "<iframe>frame text</iframe><p>end</p></body></html>"
    ),
    "uppercase": (
        "<HTML><HEAD><TITLE>Upper Case</TITLE><META NAME=\"description\" "
        "CONTENT=\"Shouty page\"></HEAD><BODY><P>Loud words</P>"
        "<A HREF=\"/loud\">Loud link</A></BODY></HTML>"
    ),
    "meta_case": (
        "<html><head><meta name=\"Description\" content=\"cased name\">"
        "<meta name=\"author\" content=\"A. Writer\"><meta name=\"keywords\">"
        "</head><body>x</body></html>"
    ),
    "titles": (
        "<html><head><title>first</title><title></title></head><body>"
        "<title>late title</title><p>body</p></body></html>"
    ),
    "empty_title": "<html><head><title></title></head><body>b</body></html>",
    "bare_text": "just some text with no tags",
    "text_then_tags": "leading words <b>bold</b> trailing",
    "voids": (
        "<html><body>line one<br>line two<br/>line three<img src=a.png>"
        "<hr><input value=x>after input</body></html>"
    ),
    "anchor_no_href": (
        "<html><body><a name='n'>named anchor</a><a href=''>empty href</a>"
        "<a href='/'>root slash</a></body></html>"
    ),
    "links_dedup": (
        "<html><body><a href='/a'>A1</a><a href='/a/'>A2</a>"
        "<a href='http://other.org/x'>ext</a><a href='http://other.org/x'>ext2"
        "</a><a href='www.plain.com'>plain</a><a href='../up.html'>up</a>"
        "<a href='pic.JPG'>pic</a></body></html>"
    ),
    "unicode": (
        "<html><head><title>Café 中文</title></head><body>"
        "<p>naïve résumé 中文字</p></body></html>"
    ),
    "nav_and_tail": (
        "<html><body><div>head<nav>menu <a href='/m'>m</a></nav>tail text"
        "</div><p>para</p></body></html>"
    ),
    "whitespace": "   \n\t  ",
    "only_comment": "<!-- nothing here -->",
    "doctype": (
        "<!DOCTYPE html><html><head><title>Doc</title></head><body>"
        "<p>typed</p></body></html>"
    ),
    "table": (
        "<html><body><table><tr><td>cell one</td><td><a href='/t'>cell link"
        "</a></td></tr></table></body></html>"
    ),
}
