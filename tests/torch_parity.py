"""Helpers for the parity tests between the JAX package and its torch port.

``same_code`` holds a copied host module (or function, or class) of the
port to its JAX original: the two must have the same abstract syntax tree
once docstrings, type hints and import statements are dropped. Comments are
not part of the tree. So a copy may differ in prose and in where it imports
from, never in what it computes.
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


def code_fingerprint(obj) -> str:
    """The AST dump of ``obj``'s source without docstrings and imports."""
    src = textwrap.dedent(inspect.getsource(obj))
    return ast.dump(_strip(ast.parse(src)), include_attributes=False)


def same_code(port_obj, jax_obj) -> bool:
    return code_fingerprint(port_obj) == code_fingerprint(jax_obj)
