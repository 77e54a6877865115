"""Build the static documentation site into docs/_site/.

Renders README.md and every docs/*.md page through python-markdown
(tables + fenced code + toc) behind a shared nav sidebar, and generates an
API reference page from the package's live docstrings (modules walked via
pkgutil, signatures via inspect) — the markdown sources stay the single
source of truth; this is the publishable equivalent of the reference's
Sphinx site (reference docs/*.rst, built on readthedocs).

Usage: python tools/build_docs.py [outdir]   (default docs/_site)
"""

import html
import importlib
import inspect
import os
import pkgutil
import re
import sys

import markdown

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


# page order in the sidebar: (source path relative to repo root, title)
PAGES = [
    ("README.md", "Overview"),
    ("docs/index.md", "Docs index"),
    ("docs/usage.md", "Usage guide"),
    ("docs/api.md", "API guide"),
    ("docs/architecture.md", "Architecture"),
    ("docs/parity.md", "Reference parity"),
    ("docs/performance.md", "Performance"),
    ("docs/mpc_theory.md", "MPC theory"),
    ("docs/inventory.md", "Component inventory"),
    ("docs/status.md", "Status"),
]

CSS = """
body { margin: 0; font: 15px/1.55 system-ui, sans-serif; color: #1a202c; }
.wrap { display: flex; min-height: 100vh; }
nav { width: 230px; flex-shrink: 0; background: #1a2233; color: #cbd5e0;
      padding: 1.2em 0; position: sticky; top: 0; height: 100vh;
      overflow-y: auto; box-sizing: border-box; }
nav h1 { font-size: 1.0em; color: #fff; padding: 0 1em .6em; margin: 0;
         border-bottom: 1px solid #2d3a55; }
nav a { display: block; color: #cbd5e0; text-decoration: none;
        padding: .32em 1em; font-size: .92em; }
nav a:hover { background: #243049; color: #fff; }
nav a.cur { background: #2b6cb0; color: #fff; }
main { flex: 1; max-width: 60em; padding: 1.5em 3em 4em; min-width: 0;
       box-sizing: border-box; }
main img { max-width: 100%; }
pre { background: #f6f8fa; border: 1px solid #e2e8f0; border-radius: 6px;
      padding: .8em 1em; overflow-x: auto; font-size: .88em; }
code { background: #f6f8fa; padding: .08em .3em; border-radius: 3px;
       font-size: .92em; }
pre code { background: none; padding: 0; }
table { border-collapse: collapse; margin: 1em 0; font-size: .92em; }
th, td { border: 1px solid #cbd5e0; padding: .35em .7em; text-align: left; }
th { background: #edf2f7; }
h1, h2, h3 { line-height: 1.25; }
h2 { border-bottom: 1px solid #e2e8f0; padding-bottom: .2em; }
.sig { background: #f0f4f8; border-left: 3px solid #2b6cb0;
       padding: .45em .8em; margin: 1.1em 0 .4em; font-family: monospace;
       font-size: .88em; overflow-x: auto; }
.doc { margin: 0 0 .6em 1em; white-space: pre-wrap; }
.mod { color: #2b6cb0; margin-top: 2em; }
"""

TEMPLATE = """<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{title} — red_gym_tpu</title><style>{css}</style></head>
<body><div class="wrap"><nav><h1>red_gym_tpu</h1>{nav}</nav>
<main>{body}</main></div></body></html>
"""


def _out_name(src):
    base = os.path.basename(src)
    return ("overview.html" if base == "README.md"
            else os.path.splitext(base)[0] + ".html")


def _nav(current, have_api):
    items = [(p, t) for p, t in PAGES
             if os.path.isfile(os.path.join(ROOT, p))]
    links = [f'<a href="{_out_name(p)}"'
             f'{" class=cur" if _out_name(p) == current else ""}>'
             f'{html.escape(t)}</a>' for p, t in items]
    if have_api:
        links.append(f'<a href="api_ref.html"'
                     f'{" class=cur" if current == "api_ref.html" else ""}>'
                     f'API reference</a>')
    return "\n".join(links)


def _rewrite_links(text):
    # make intra-repo markdown links point at the rendered pages
    def sub(m):
        target = m.group(2)
        base = os.path.basename(target.split("#")[0])
        known = {os.path.basename(p) for p, _ in PAGES}
        if base in known:
            frag = target.split("#")[1] if "#" in target else None
            new = _out_name(base) + (f"#{frag}" if frag else "")
            return f"[{m.group(1)}]({new})"
        return m.group(0)
    return re.sub(r"\[([^\]]+)\]\(([^)\s]+\.md(?:#[^)]*)?)\)", sub, text)


def render_pages(outdir, have_api):
    md = markdown.Markdown(extensions=["tables", "fenced_code", "toc"])
    built = []
    for src, title in PAGES:
        path = os.path.join(ROOT, src)
        if not os.path.isfile(path):
            continue
        with open(path) as f:
            body = md.reset().convert(_rewrite_links(f.read()))
        out = _out_name(src)
        with open(os.path.join(outdir, out), "w") as f:
            f.write(TEMPLATE.format(title=html.escape(title), css=CSS,
                                    nav=_nav(out, have_api), body=body))
        built.append(out)
    return built


def _doc_first(obj, n=60):
    doc = inspect.getdoc(obj) or ""
    lines = doc.splitlines()
    return "\n".join(lines[:n])


def api_reference(outdir):
    import red_gym_tpu

    parts = ["<h1>API reference</h1>",
             "<p>Generated from live docstrings by tools/build_docs.py; "
             "reference-file citations inside docstrings point at the "
             "upstream lines each API mirrors.</p>"]
    mods = ["red_gym_tpu"]
    for m in pkgutil.walk_packages(red_gym_tpu.__path__,
                                   prefix="red_gym_tpu."):
        if ".assets" in m.name or m.name.endswith("__main__"):
            continue
        mods.append(m.name)
    for name in sorted(set(mods)):
        try:
            mod = importlib.import_module(name)
        except Exception as exc:        # optional deps (display-less render)
            parts.append(f'<h2 class="mod">{name}</h2>'
                         f'<p><em>not importable here: '
                         f'{html.escape(str(exc))}</em></p>')
            continue
        parts.append(f'<h2 class="mod" id="{name}">{name}</h2>')
        if inspect.getdoc(mod):
            parts.append(f'<div class="doc">'
                         f'{html.escape(_doc_first(mod, 12))}</div>')
        for attr, obj in sorted(vars(mod).items()):
            if attr.startswith("_"):
                continue
            if not (inspect.isfunction(obj) or inspect.isclass(obj)):
                continue
            if getattr(obj, "__module__", None) != name:
                continue        # skip re-exports; documented at home module
            try:
                sig = str(inspect.signature(obj))
            except (TypeError, ValueError):
                sig = "(...)"
            kind = "class" if inspect.isclass(obj) else "def"
            parts.append(f'<div class="sig">{kind} '
                         f'<b>{html.escape(attr)}</b>'
                         f'{html.escape(sig)}</div>')
            doc = _doc_first(obj)
            if doc:
                parts.append(f'<div class="doc">{html.escape(doc)}</div>')
    body = "\n".join(parts)
    with open(os.path.join(outdir, "api_ref.html"), "w") as f:
        f.write(TEMPLATE.format(title="API reference", css=CSS,
                                nav=_nav("api_ref.html", True), body=body))


def main(outdir=None):
    outdir = outdir or os.path.join(ROOT, "docs", "_site")
    os.makedirs(outdir, exist_ok=True)
    api_reference(outdir)
    # docs/index.md renders to index.html and doubles as the site root
    # (no redirect: a redirect here would overwrite the rendered page)
    pages = render_pages(outdir, have_api=True)
    # committed curve plots/CSVs referenced by the pages (docs/media/...)
    media_src = os.path.join(ROOT, "docs", "media")
    if os.path.isdir(media_src):
        import shutil
        shutil.copytree(media_src, os.path.join(outdir, "media"),
                        dirs_exist_ok=True)
    print(f"built {len(pages) + 1} pages -> {outdir}")
    return outdir


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
