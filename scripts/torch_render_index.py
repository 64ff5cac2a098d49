"""Build a browsable index.html over rendered episode SVGs (the JAX
package's ``scripts/render_index.py``, for the port's renders).

The port renders greedy episodes as animated SVG files
(``cm3_tpu_torch/envs/render.py``; ``python -m
cm3_tpu_torch.train.runner --render-episodes K --workdir DIR`` writes
them under ``DIR/render/<dir_name>/``).  This writes one static HTML
page per render root that embeds every episode SVG below it, grouped by
directory: open ``index.html`` in any browser, no dependencies; the
animations play through SMIL.

    python3 scripts/torch_render_index.py [root ...]
        (default: runs/reproduce_torch/render)
"""

from __future__ import annotations

import html
import os
import sys

STYLE = """
body { font-family: system-ui, sans-serif; margin: 2em; background: #fafafa; }
h1 { font-size: 1.4em; } h2 { font-size: 1.1em; margin-top: 1.6em;
     border-bottom: 1px solid #ddd; padding-bottom: .3em; }
.ep { display: inline-block; margin: .5em; vertical-align: top;
      background: #fff; border: 1px solid #ddd; border-radius: 6px;
      padding: .5em; }
.ep figcaption { font-size: .8em; color: #555; text-align: center;
                 margin-top: .3em; }
object { max-width: 480px; }
"""


def build_index(root: str) -> str | None:
    """Write ``root``/index.html embedding every ``*.svg`` below root
    (grouped by immediate subdirectory).  Returns the path, or None if
    no SVGs were found."""
    groups = {}
    for dirpath, _dirs, files in sorted(os.walk(root)):
        svgs = sorted(f for f in files if f.endswith(".svg"))
        if not svgs:
            continue
        rel_dir = os.path.relpath(dirpath, root)
        groups[rel_dir] = [os.path.join(rel_dir, f) if rel_dir != "." else f
                           for f in svgs]
    if not groups:
        return None
    parts = ["<!doctype html><html><head><meta charset='utf-8'>",
             f"<title>{html.escape(os.path.basename(root) or root)} — "
             "episode renders</title>",
             f"<style>{STYLE}</style></head><body>",
             f"<h1>Episode renders — {html.escape(root)}</h1>",
             "<p>Animated-SVG greedy-policy episodes "
             "(cm3_tpu_torch/envs/render.py; the headless counterpart "
             "of the reference's multiagent/rendering.py viewer). Animations "
             "autoplay.</p>"]
    for rel_dir, svgs in sorted(groups.items()):
        title = "(root)" if rel_dir == "." else rel_dir
        parts.append(f"<h2>{html.escape(title)}</h2>")
        for rel in svgs:
            name = os.path.basename(rel)
            parts.append(
                f"<figure class='ep'>"
                f"<object type='image/svg+xml' "
                f"data='{html.escape(rel)}'></object>"
                f"<figcaption>{html.escape(name)}</figcaption></figure>")
    parts.append("</body></html>")
    out = os.path.join(root, "index.html")
    with open(out, "w") as f:
        f.write("\n".join(parts))
    return out


def main():
    roots = sys.argv[1:] or ["runs/reproduce_torch/render"]
    for root in roots:
        if not os.path.isdir(root):
            print(f"skip {root} (missing)")
            continue
        out = build_index(root)
        print(out or f"skip {root} (no SVGs)")


if __name__ == "__main__":
    main()
