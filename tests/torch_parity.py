"""Helpers for the parity tests between the JAX package and its torch port.

``same_code`` holds a copied host module (or function, or class) of the
port to its JAX original: the two must have the same abstract syntax tree
once docstrings, type hints and import statements are dropped. Comments are
not part of the tree. So a copy may differ in prose and in where it imports
from, never in what it computes.

``same_code_but_device`` is ``same_code`` for a copy whose only change is
the ``device`` it takes and passes on (the port's entry points run on the
card unless a caller asks for the CPU): it also drops every parameter named
``device``, every ``device=...`` keyword of a call and every
``self.device = device`` statement from the port's tree.
"""

from __future__ import annotations

import ast
import inspect
import textwrap


def _strip(tree: ast.AST) -> ast.AST:
    for node in ast.walk(tree):
        # type hints name the array type (jax.Array vs torch.Tensor) and
        # compute nothing under `from __future__ import annotations`
        if isinstance(node, ast.arg):
            node.annotation = None
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            node.returns = None
        body = getattr(node, "body", None)
        if not isinstance(body, list):
            continue
        node.body = [
            stmt for stmt in body
            if not isinstance(stmt, (ast.Import, ast.ImportFrom))
            and not (
                isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Constant)
                and isinstance(stmt.value.value, str)
            )
        ]
    return tree


def _drop_device(tree: ast.AST) -> ast.AST:
    for node in ast.walk(tree):
        if isinstance(node, ast.arguments):
            npo = len(node.posonlyargs)
            pos = node.posonlyargs + node.args
            # defaults belong to the last positional parameters
            defaults = ([None] * (len(pos) - len(node.defaults))
                        + list(node.defaults))
            keep = [a.arg != "device" for a in pos]
            node.posonlyargs = [a for a, k in zip(pos[:npo], keep[:npo]) if k]
            node.args = [a for a, k in zip(pos[npo:], keep[npo:]) if k]
            node.defaults = [d for d, k in zip(defaults, keep)
                             if k and d is not None]
            pairs = [(a, d) for a, d in zip(node.kwonlyargs, node.kw_defaults)
                     if a.arg != "device"]
            node.kwonlyargs = [a for a, _ in pairs]
            node.kw_defaults = [d for _, d in pairs]
        if isinstance(node, ast.Call):
            node.keywords = [k for k in node.keywords if k.arg != "device"]
        body = getattr(node, "body", None)
        if isinstance(body, list):
            node.body = [
                stmt for stmt in body
                if not (isinstance(stmt, ast.Assign)
                        and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Attribute)
                        and stmt.targets[0].attr == "device")
            ]
    return tree


def code_fingerprint(obj, *, drop_device: bool = False) -> str:
    """The AST dump of ``obj``'s source without docstrings and imports
    (and, with ``drop_device``, without its ``device`` plumbing)."""
    src = textwrap.dedent(inspect.getsource(obj))
    tree = _strip(ast.parse(src))
    if drop_device:
        tree = _drop_device(tree)
    return ast.dump(tree, include_attributes=False)


def same_code(port_obj, jax_obj) -> bool:
    return code_fingerprint(port_obj) == code_fingerprint(jax_obj)


def same_code_but_device(port_obj, jax_obj) -> bool:
    return (code_fingerprint(port_obj, drop_device=True)
            == code_fingerprint(jax_obj))
