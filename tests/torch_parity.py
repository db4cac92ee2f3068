"""Helpers for the parity tests between the JAX package and its torch port.

``same_code`` holds a copied host module (or function, or class) of the
port to its JAX original: the two must have the same abstract syntax tree
once docstrings, type hints and import statements are dropped. Comments are
not part of the tree. So a copy may differ in prose and in where it imports
from, never in what it computes.

``same_code_but_device`` is ``same_code`` for a copy whose only change is
the ``device`` it takes and passes on (the port's entry points run on the
card unless a caller asks for the CPU): it also drops every parameter named
``device``, every ``device=...`` keyword of a call, every
``self.device = device`` statement and every ``"device": ...`` entry of a
dict literal from the port's tree. With ``spans=True`` it also drops the
profiling spans of both trees, which compute nothing: a ``with`` block of
``stage(...)`` or ``request(...)`` stands for its body, and an ``@entry``
decorator goes.

``same_code_but_clock`` is ``same_code`` for a copy that takes a reply's
``wall_ms`` from its profiling request span instead of its own clock:
spans dropped as above, and on both sides the ``t0 = time.perf_counter()``
statement and the ``wall_ms=`` value left out.
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
        if isinstance(node, ast.Dict):
            # a daemon's state dict that carries the device it serves on
            pairs = [(k, v) for k, v in zip(node.keys, node.values)
                     if not (isinstance(k, ast.Constant) and k.value == "device")]
            node.keys = [k for k, _ in pairs]
            node.values = [v for _, v in pairs]
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


_SPAN_OPENERS = ("stage", "request")


def _is_span(expr: ast.AST) -> bool:
    """``stage(...)``, ``request(...)`` or the same through ``profiling.``."""
    if not isinstance(expr, ast.Call):
        return False
    f = expr.func
    if isinstance(f, ast.Name):
        return f.id in _SPAN_OPENERS
    return (isinstance(f, ast.Attribute) and f.attr in _SPAN_OPENERS
            and isinstance(f.value, ast.Name) and f.value.id == "profiling")


def _inline_spans(stmts: list) -> list:
    out = []
    for stmt in stmts:
        if (isinstance(stmt, ast.With)
                and all(_is_span(it.context_expr) for it in stmt.items)):
            out.extend(_inline_spans(stmt.body))
        else:
            out.append(stmt)
    return out


def _drop_spans(tree: ast.AST) -> ast.AST:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            node.decorator_list = [
                d for d in node.decorator_list
                if not (isinstance(d, ast.Name) and d.id == "entry")]
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            if isinstance(stmts, list):
                setattr(node, field, _inline_spans(stmts))
    return tree


def _is_clock_start(stmt: ast.AST) -> bool:
    return (isinstance(stmt, ast.Assign)
            and isinstance(stmt.value, ast.Call)
            and ast.unparse(stmt.value.func) == "time.perf_counter")


def _drop_clock(tree: ast.AST) -> ast.AST:
    for node in ast.walk(tree):
        if isinstance(node, ast.keyword) and node.arg == "wall_ms":
            node.value = ast.Constant(None)
        body = getattr(node, "body", None)
        if isinstance(body, list):
            node.body = [stmt for stmt in body if not _is_clock_start(stmt)]
    return tree


def code_fingerprint(obj, *, drop_device: bool = False,
                     drop_spans: bool = False,
                     drop_clock: bool = False) -> str:
    """The AST dump of ``obj``'s source without docstrings and imports
    (and, with ``drop_device``, without its ``device`` plumbing; with
    ``drop_spans``, without its profiling spans; with ``drop_clock``,
    without its reply clock)."""
    src = textwrap.dedent(inspect.getsource(obj))
    tree = _strip(ast.parse(src))
    if drop_device:
        tree = _drop_device(tree)
    if drop_spans:
        tree = _drop_spans(tree)
    if drop_clock:
        tree = _drop_clock(tree)
    return ast.dump(tree, include_attributes=False)


def same_code(port_obj, jax_obj) -> bool:
    return code_fingerprint(port_obj) == code_fingerprint(jax_obj)


def same_code_but_device(port_obj, jax_obj, *, spans: bool = False) -> bool:
    return (code_fingerprint(port_obj, drop_device=True, drop_spans=spans)
            == code_fingerprint(jax_obj, drop_spans=spans))


def same_code_but_clock(port_obj, jax_obj) -> bool:
    return (code_fingerprint(port_obj, drop_spans=True, drop_clock=True)
            == code_fingerprint(jax_obj, drop_spans=True, drop_clock=True))
