"""Module dependency graph generator (port of
``minizero_tpu/tools/dependency_graph.py``; a development tool).

The counterpart of the reference's include-graph tool
(``tools/dependency_graph_generator/`` -> graphml of C++ includes): walks the
``minizero_tpu_torch`` package, extracts intra-package imports from each
module's AST, and emits GraphML or Graphviz dot.

    python -m minizero_tpu_torch.tools.dependency_graph -out deps.graphml
    python -m minizero_tpu_torch.tools.dependency_graph -format dot -out deps.dot
"""

from __future__ import annotations

import argparse
import ast
import os
from typing import Dict, List, Set, Tuple

PACKAGE = "minizero_tpu_torch"


def _module_name(root: str, path: str) -> str:
    rel = os.path.relpath(path, os.path.dirname(root))
    mod = rel[:-3].replace(os.sep, ".")
    return mod[:-len(".__init__")] if mod.endswith(".__init__") else mod


def collect_edges(package_dir: str) -> Tuple[List[str], Set[Tuple[str, str]]]:
    """Return (modules, edges) where an edge (a, b) means module a imports b."""
    modules: List[str] = []
    sources: Dict[str, str] = {}
    for dirpath, _, files in os.walk(package_dir):
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            mod = _module_name(package_dir, path)
            modules.append(mod)
            sources[mod] = path

    edges: Set[Tuple[str, str]] = set()
    known = set(modules)
    for mod, path in sources.items():
        with open(path, "r", encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            targets: List[str] = []
            if isinstance(node, ast.Import):
                targets = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                base = node.module
                if node.level:  # relative import -> resolve against mod
                    parts = mod.split(".")[: -node.level]
                    base = ".".join(parts + [node.module])
                targets = [base] + [f"{base}.{a.name}" for a in node.names]
            for t in targets:
                if not t.startswith(PACKAGE):
                    continue
                # longest known prefix (from X import name may name a symbol)
                while t and t not in known:
                    t = t.rpartition(".")[0]
                if t and t != mod:
                    edges.add((mod, t))
    return modules, edges


def to_graphml(modules: List[str], edges: Set[Tuple[str, str]]) -> str:
    ids = {m: f"n{i}" for i, m in enumerate(modules)}
    lines = [
        '<?xml version="1.0" encoding="UTF-8"?>',
        '<graphml xmlns="http://graphml.graphdrawing.org/xmlns">',
        '  <key id="label" for="node" attr.name="label" attr.type="string"/>',
        '  <graph id="deps" edgedefault="directed">',
    ]
    for m in modules:
        lines.append(f'    <node id="{ids[m]}"><data key="label">{m}</data></node>')
    for a, b in sorted(edges):
        lines.append(f'    <edge source="{ids[a]}" target="{ids[b]}"/>')
    lines += ["  </graph>", "</graphml>", ""]
    return "\n".join(lines)


def to_dot(modules: List[str], edges: Set[Tuple[str, str]]) -> str:
    lines = ["digraph deps {", "  rankdir=LR;"]
    for m in modules:
        lines.append(f'  "{m}";')
    for a, b in sorted(edges):
        lines.append(f'  "{a}" -> "{b}";')
    lines += ["}", ""]
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-out", default="deps.graphml")
    parser.add_argument("-format", choices=["graphml", "dot"], default="graphml")
    args = parser.parse_args(argv)

    package_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    modules, edges = collect_edges(package_dir)
    text = to_graphml(modules, edges) if args.format == "graphml" else to_dot(modules, edges)
    with open(args.out, "w", encoding="utf-8") as f:
        f.write(text)
    print(f"{len(modules)} modules, {len(edges)} edges -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
