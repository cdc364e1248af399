"""Jit-purity lint.

Host-sync calls inside a jitted function either crash at trace time
(``float()`` on a tracer) or — worse — silently execute at trace time
only, baking one value into the compiled program.  Inside the decode
``lax.scan`` a host sync would force a device round-trip per step,
which is exactly the dispatch overhead the engine exists to remove.

Jitted functions are recognised in three forms::

    @jax.jit                                  # (also bare @jit)
    def f(...): ...

    @functools.partial(jax.jit, static_argnames=(...))
    def g(...): ...

    h = jax.jit(fn)                           # assignment form

Pallas kernel bodies are jit roots too: a def passed (directly, via
``functools.partial(kernel, ...)`` inline, or through a local
``k = functools.partial(kernel, ...)`` alias) as the first argument of
``pl.pallas_call`` is traced exactly like a jitted def, so host syncs
inside it get the same treatment.

Inside a jitted def — including nested defs, which covers scan/cond
bodies — these are flagged: ``float(x)`` / ``int(x)`` / ``bool(x)`` on
a non-constant argument, ``np.asarray`` / ``np.array`` /
``numpy.asarray``, ``.block_until_ready()``, ``.item()``, ``.tolist()``,
and ``jax.device_get``.

Rule name: ``jit-purity``.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.common import (SourceFile, Violation, attr_chain,
                                   filter_suppressed)

RULE = "jit-purity"

HOST_CASTS = {"float", "int", "bool"}
NUMPY_FNS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
             "onp.asarray", "onp.array"}
HOST_METHODS = {"block_until_ready", "item", "tolist"}


def _is_jit_expr(node: ast.AST) -> bool:
    """jax.jit / jit / functools.partial(jax.jit, ...) / partial(jax.jit,..)"""
    dotted = attr_chain(node)
    if dotted in ("jax.jit", "jit"):
        return True
    if isinstance(node, ast.Call):
        fn = attr_chain(node.func)
        if fn in ("functools.partial", "partial") and node.args:
            return _is_jit_expr(node.args[0])
        # jax.jit(f) used directly as a decorator-with-args or value
        if attr_chain(node.func) in ("jax.jit", "jit"):
            return True
    return False


PALLAS_CALLS = ("pl.pallas_call", "pallas_call", "pallas.pallas_call",
                "jax.experimental.pallas.pallas_call")


def _kernel_name(node: ast.AST,
                 partial_aliases: Dict[str, str]) -> Optional[str]:
    """Resolve pallas_call's first arg to the kernel def's name: a bare
    Name (through a partial alias if one is in scope) or an inline
    ``functools.partial(kernel, ...)``."""
    if isinstance(node, ast.Name):
        return partial_aliases.get(node.id, node.id)
    if isinstance(node, ast.Call):
        fn = attr_chain(node.func)
        if (fn in ("functools.partial", "partial") and node.args
                and isinstance(node.args[0], ast.Name)):
            return node.args[0].id
    return None


def _jitted_defs(tree: ast.Module) -> Set[ast.AST]:
    """All function defs that are jitted — via decorator, ``jax.jit(f)``
    assignment, or as a ``pl.pallas_call`` kernel body — plus every def
    nested in one."""
    roots: Set[ast.AST] = set()
    fn_by_name: Dict[str, ast.AST] = {}
    partial_aliases: Dict[str, str] = {}

    # pass 1: names, decorator roots, partial aliases
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn_by_name.setdefault(node.name, node)
            if any(_is_jit_expr(d) for d in node.decorator_list):
                roots.add(node)
        elif isinstance(node, ast.Assign):
            # k = functools.partial(kernel, ...)
            if (isinstance(node.value, ast.Call)
                    and attr_chain(node.value.func) in ("functools.partial",
                                                        "partial")
                    and node.value.args
                    and isinstance(node.value.args[0], ast.Name)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                partial_aliases[node.targets[0].id] = node.value.args[0].id

    # pass 2: assignment-form jit and pallas_call kernel bodies
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            # h = jax.jit(fn)  -> mark fn's def if visible in this module
            if (isinstance(node.value, ast.Call)
                    and attr_chain(node.value.func) in ("jax.jit", "jit")
                    and node.value.args
                    and isinstance(node.value.args[0], ast.Name)):
                name = node.value.args[0].id
                if name in fn_by_name:
                    roots.add(fn_by_name[name])
        elif (isinstance(node, ast.Call)
              and attr_chain(node.func) in PALLAS_CALLS and node.args):
            name = _kernel_name(node.args[0], partial_aliases)
            if name and name in fn_by_name:
                roots.add(fn_by_name[name])

    out: Set[ast.AST] = set()
    for r in roots:
        for node in ast.walk(r):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                out.add(node)
    return out


def _scan_def(fn: ast.AST, path: str) -> List[Violation]:
    out: List[Violation] = []
    body = fn.body if not isinstance(fn, ast.Lambda) else [fn.body]
    for stmt in body:
        for node in ast.walk(stmt if isinstance(stmt, ast.AST) else stmt):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue  # nested defs handled as their own entries
            if not isinstance(node, ast.Call):
                continue
            dotted = attr_chain(node.func)
            name = getattr(fn, "name", "<lambda>")
            if dotted in HOST_CASTS and node.args and not isinstance(
                    node.args[0], ast.Constant):
                out.append(Violation(
                    RULE, path, node.lineno,
                    f"host cast {dotted}() on a traced value inside jitted "
                    f"`{name}`"))
            elif dotted in NUMPY_FNS or dotted == "jax.device_get":
                out.append(Violation(
                    RULE, path, node.lineno,
                    f"host-sync {dotted}() inside jitted `{name}`"))
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in HOST_METHODS):
                out.append(Violation(
                    RULE, path, node.lineno,
                    f"host-sync .{node.func.attr}() inside jitted `{name}`"))
    return out


def check_file(src: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    path = str(src.path)
    seen_lines: Set[int] = set()
    for fn in _jitted_defs(src.tree):
        for v in _scan_def(fn, path):
            if v.line not in seen_lines:   # nested defs overlap parents
                seen_lines.add(v.line)
                out.append(v)
    return filter_suppressed(src, sorted(out, key=lambda v: v.line))
