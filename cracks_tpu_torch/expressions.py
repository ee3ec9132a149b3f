"""Tiny safe arithmetic expression evaluator.

The reference configuration system supports expression-valued parameters
(via deal.II FunctionParser, see reference cracks.cc:1490-1491 and
cracks.cc:3876-3883): ``Pressure`` is a function of ``time`` and
``K reg`` / ``Eps reg`` are functions of the mesh size ``h``.  Examples
appearing in the shipped parameter files::

    1e-8*h
    2.0*h
    0 + time *1e3
    0.25 * pow(h,0.5)

We evaluate these with a restricted AST walker (no eval of arbitrary
Python).
"""

from __future__ import annotations

import ast
import math
import operator

_BINOPS = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.Pow: operator.pow,
    ast.Mod: operator.mod,
}

_UNARYOPS = {
    ast.USub: operator.neg,
    ast.UAdd: operator.pos,
}

_FUNCS = {
    "pow": math.pow,
    "sqrt": math.sqrt,
    "exp": math.exp,
    "log": math.log,
    "sin": math.sin,
    "cos": math.cos,
    "tan": math.tan,
    "abs": abs,
    "min": min,
    "max": max,
    "floor": math.floor,
    "ceil": math.ceil,
}

_CONSTS = {
    "pi": math.pi,
    "e": math.e,
}


class ExpressionError(ValueError):
    pass


def _eval_node(node: ast.AST, variables: dict[str, float]) -> float:
    if isinstance(node, ast.Expression):
        return _eval_node(node.body, variables)
    if isinstance(node, ast.Constant):
        if isinstance(node.value, (int, float)):
            return float(node.value)
        raise ExpressionError(f"non-numeric constant {node.value!r}")
    if isinstance(node, ast.Name):
        if node.id in variables:
            return float(variables[node.id])
        if node.id in _CONSTS:
            return _CONSTS[node.id]
        raise ExpressionError(f"unknown variable {node.id!r}")
    if isinstance(node, ast.BinOp):
        op = _BINOPS.get(type(node.op))
        if op is None:
            raise ExpressionError(f"operator {type(node.op).__name__} not allowed")
        return op(_eval_node(node.left, variables), _eval_node(node.right, variables))
    if isinstance(node, ast.UnaryOp):
        op = _UNARYOPS.get(type(node.op))
        if op is None:
            raise ExpressionError(f"operator {type(node.op).__name__} not allowed")
        return op(_eval_node(node.operand, variables))
    if isinstance(node, ast.Call):
        if not isinstance(node.func, ast.Name) or node.func.id not in _FUNCS:
            raise ExpressionError("only whitelisted function calls allowed")
        if node.keywords:
            raise ExpressionError("keyword arguments not allowed")
        args = [_eval_node(a, variables) for a in node.args]
        return float(_FUNCS[node.func.id](*args))
    raise ExpressionError(f"syntax element {type(node).__name__} not allowed")


def evaluate(expression: str, **variables: float) -> float:
    """Evaluate an arithmetic expression with the given variables.

    >>> evaluate("2.0*h", h=0.5)
    1.0
    >>> evaluate("0 + time *1e3", time=0.01)
    10.0
    """
    expression = expression.strip()
    if not expression:
        raise ExpressionError("empty expression")
    # FunctionParser uses '^' for powers; Python uses '**'.
    expression = expression.replace("^", "**")
    try:
        tree = ast.parse(expression, mode="eval")
    except SyntaxError as exc:
        raise ExpressionError(f"cannot parse {expression!r}: {exc}") from exc
    return _eval_node(tree, variables)


class Expression:
    """A compiled expression of named variables, callable with kwargs."""

    def __init__(self, text: str):
        self.text = text.strip()

    def __call__(self, **variables: float) -> float:
        return evaluate(self.text, **variables)

    def __repr__(self) -> str:
        return f"Expression({self.text!r})"
