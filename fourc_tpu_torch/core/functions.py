"""Symbolic space-time functions (deck FUNCT entries).

Counterpart of fourc_tpu/core/functions.py: the same tokenizer and
recursive-descent parser, evaluated with numpy on host floats and arrays
(prescribed values and surface loads), or with torch on a tensor of
coordinates on its device (body forces, whose Gauss points cover the whole
mesh: ``FunctionOfSpaceTime.on_device``).  ``MultiFunctionOfTime`` is the
reference's piecewise-in-time FUNCT, with the knot and range rules of
``MultiFunctionOfTime.piece``.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

import numpy as np
import torch

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)"
    r"|(?P<name>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op>\*\*|<=|>=|[-+*/^(),<>]))"
)

_FUNCS = {
    "sin": np.sin, "cos": np.cos, "tan": np.tan,
    "asin": np.arcsin, "acos": np.arccos, "atan": np.arctan,
    "sinh": np.sinh, "cosh": np.cosh, "tanh": np.tanh,
    "exp": np.exp, "log": np.log, "log10": np.log10, "sqrt": np.sqrt,
    "abs": np.abs, "fabs": np.abs,
    "heaviside": lambda x: np.where(x > 0, 1.0, 0.0),
    "atan2": np.arctan2, "pow": np.power,
    "min": np.minimum, "max": np.maximum,
}

_CONSTS = {"pi": math.pi, "e": math.e}


def _tokenize(src: str):
    out, pos = [], 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m or m.end() == pos:
            if src[pos:].strip() == "":
                break
            raise ValueError(f"cannot tokenize expression at: {src[pos:]!r}")
        pos = m.end()
        if m.group("num") is not None:
            out.append(("num", float(m.group("num"))))
        elif m.group("name") is not None:
            out.append(("name", m.group("name")))
        else:
            out.append(("op", m.group("op")))
    out.append(("end", None))
    return out


class _Parser:
    """Recursive descent: comparisons, + -, * /, unary -, ^ (right assoc),
    calls."""

    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, op):
        k, v = self.next()
        if k != "op" or v != op:
            raise ValueError(f"expected {op!r}, got {v!r}")

    def parse(self):
        e = self.compare()
        if self.peek()[0] != "end":
            raise ValueError(f"trailing tokens: {self.toks[self.i:]}")
        return e

    def compare(self):
        node = self.expr()
        while self.peek() in (("op", "<"), ("op", ">"), ("op", "<="),
                              ("op", ">=")):
            op = self.next()[1]
            node = (op, node, self.expr())
        return node

    def expr(self):
        node = self.term()
        while self.peek() in (("op", "+"), ("op", "-")):
            op = self.next()[1]
            node = (op, node, self.term())
        return node

    def term(self):
        node = self.unary()
        while self.peek() in (("op", "*"), ("op", "/")):
            op = self.next()[1]
            node = (op, node, self.unary())
        return node

    def unary(self):
        if self.peek() == ("op", "-"):
            self.next()
            return ("neg", self.unary())
        if self.peek() == ("op", "+"):
            self.next()
            return self.unary()
        return self.power()

    def power(self):
        base = self.atom()
        if self.peek() in (("op", "^"), ("op", "**")):
            self.next()
            return ("^", base, self.unary())
        return base

    def atom(self):
        kind, val = self.next()
        if kind == "num":
            return ("const", val)
        if kind == "name":
            if self.peek() == ("op", "("):
                self.next()
                args = [self.compare()]
                while self.peek() == ("op", ","):
                    self.next()
                    args.append(self.compare())
                self.expect(")")
                if val not in _FUNCS:
                    raise ValueError(f"unknown function {val!r}")
                return ("call", val, args)
            if val in _CONSTS:
                return ("const", _CONSTS[val])
            return ("var", val)
        if kind == "op" and val == "(":
            e = self.compare()
            self.expect(")")
            return e
        raise ValueError(f"unexpected token {val!r}")


_BINARY = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "^": lambda a, b: a ** b,
    "<": lambda a, b: np.where(a < b, 1.0, 0.0),
    ">": lambda a, b: np.where(a > b, 1.0, 0.0),
    "<=": lambda a, b: np.where(a <= b, 1.0, 0.0),
    ">=": lambda a, b: np.where(a >= b, 1.0, 0.0),
}


def _cmp(op):
    """A comparison as 1.0 / 0.0 in its operands' dtype."""
    def f(a, b):
        if not (torch.is_tensor(a) or torch.is_tensor(b)):
            return float(op(a, b))
        return op(a, b).to(torch.result_type(a, b))

    return f


_TORCH_FUNCS = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "exp": torch.exp, "log": torch.log, "log10": torch.log10,
    "sqrt": torch.sqrt, "abs": torch.abs, "fabs": torch.abs,
    "heaviside": lambda x: (x > 0).to(x.dtype),
    "atan2": torch.atan2, "pow": torch.pow,
    "min": torch.minimum, "max": torch.maximum,
}
_TORCH_BINARY = {**_BINARY,
                 "<": _cmp(lambda a, b: a < b),
                 ">": _cmp(lambda a, b: a > b),
                 "<=": _cmp(lambda a, b: a <= b),
                 ">=": _cmp(lambda a, b: a >= b)}


def _eval(node, env, funcs=_FUNCS, binary=_BINARY):
    """Evaluate a parsed expression; with ``funcs``/``binary`` the torch
    tables, every variable of ``env`` must be a tensor."""
    tag = node[0]
    if tag == "const":
        return node[1]
    if tag == "var":
        try:
            return env[node[1]]
        except KeyError:
            raise ValueError(
                f"unknown variable {node[1]!r} in expression") from None
    if tag == "neg":
        return -_eval(node[1], env, funcs, binary)
    if tag == "call":
        args = [_eval(a, env, funcs, binary) for a in node[2]]
        if funcs is _TORCH_FUNCS:  # constant arguments as tensors
            like = env["t"]
            args = [a if torch.is_tensor(a) else like.new_tensor(a)
                    for a in args]
        return funcs[node[1]](*args)
    return binary[tag](_eval(node[1], env, funcs, binary),
                       _eval(node[2], env, funcs, binary))


@dataclass
class SymbolicExpression:
    """A parsed expression of x, y, z, t (numpy-broadcasting)."""

    src: str
    ast: tuple = field(repr=False, default=None)

    def __post_init__(self):
        if self.ast is None:
            self.ast = _Parser(_tokenize(self.src)).parse()

    def __call__(self, x=0.0, y=0.0, z=0.0, t=0.0, **params):
        env = {"x": x, "y": y, "z": z, "t": t}
        env.update(params)
        return _eval(self.ast, env)

    def on_device(self, t: torch.Tensor):
        """The expression at a tensor of times (one per Gauss point, say),
        x = y = z = 0, evaluated by torch on their device in their dtype
        (comparisons 1.0 / 0.0): a tensor of t's shape."""
        zero = torch.zeros_like(t)
        out = _eval(self.ast, {"x": zero, "y": zero, "z": zero, "t": t},
                    _TORCH_FUNCS, _TORCH_BINARY)
        if not torch.is_tensor(out):
            out = t.new_tensor(out)
        return out.expand(t.shape)


@dataclass
class FunctionOfSpaceTime:
    """A FUNCT entry: one expression per component."""

    components: list

    @classmethod
    def from_spec(cls, spec) -> "FunctionOfSpaceTime":
        if isinstance(spec, str):
            spec = [spec]
        return cls([SymbolicExpression(s) for s in spec])

    def __call__(self, coords, t, component=None):
        """coords: (..., dim) array; returns (..., ncomp) or (...,)."""
        coords = np.asarray(coords, dtype=np.float64)
        x = coords[..., 0]
        y = coords[..., 1] if coords.shape[-1] > 1 else 0.0 * x
        z = coords[..., 2] if coords.shape[-1] > 2 else 0.0 * x

        def ev(c):
            return np.broadcast_to(np.asarray(c(x, y, z, float(t)),
                                              np.float64), x.shape)

        if component is not None:
            return ev(self.components[min(component,
                                          len(self.components) - 1)])
        return np.stack([ev(c) for c in self.components], axis=-1)

    def on_device(self, coords: torch.Tensor, t, component=0):
        """One component at a tensor of coordinates (..., d), evaluated by
        torch on their device in their dtype: (...).  ``t`` a number or a
        0-d tensor (``torch.func.jvp`` in t: ``DirichletHandler.rates``)."""
        zero = torch.zeros_like(coords[..., 0])
        env = {"x": coords[..., 0],
               "y": coords[..., 1] if coords.shape[-1] > 1 else zero,
               "z": coords[..., 2] if coords.shape[-1] > 2 else zero,
               "t": t if torch.is_tensor(t) else coords.new_tensor(float(t))}
        c = self.components[min(component, len(self.components) - 1)]
        out = _eval(c.ast, env, _TORCH_FUNCS, _TORCH_BINARY)
        if not torch.is_tensor(out):
            out = coords.new_tensor(out)
        return out.expand(coords.shape[:-1])

    def at_time(self, t):
        """The function that holds at time t (a number): itself."""
        return self


class MultiFunctionOfTime:
    """A piecewise-in-time FUNCT (the reference's ``multifunction``: knot
    times t_0 < ... < t_n and one expression of x, y, z, t per interval).

    The reference returns 0 outside [t_0, t_n] and compares times with the
    knots exactly, so a time that rounds a hair past a knot takes the next
    piece.  Here a time outside the range raises, naming the function, and
    a time within ``KNOT_TOL`` (relative) of an interior knot is that knot,
    whose piece is the interval that ends there (left-open, right-closed,
    t_0 in the first), as 4C's segment search takes the first interval
    whose end is not below t; the rate at the knot is then the left
    piece's."""

    KNOT_TOL = 1e-12

    def __init__(self, times, pieces, name="multifunction"):
        if len(pieces) != len(times) - 1:
            raise ValueError("multifunction needs len(times)-1 pieces")
        self.times = [float(v) for v in times]
        if any(b <= a for a, b in zip(self.times, self.times[1:])):
            raise ValueError(f"{name}: knot times must increase")
        self.name = name
        self.pieces = [FunctionOfSpaceTime([SymbolicExpression(str(p))])
                       for p in pieces]
        self.components = [self]

    def piece(self, t) -> int:
        """The index of the piece that holds at time t (a number)."""
        t = float(t)

        def near(knot):  # t is the knot, to KNOT_TOL relative
            return abs(t - knot) <= self.KNOT_TOL * max(1.0, abs(knot))

        lo, hi = self.times[0], self.times[-1]
        if not (lo <= t <= hi or near(lo) or near(hi)):
            raise ValueError(
                f"{self.name}: t = {t!r} lies outside its time range "
                f"[{lo!r}, {hi!r}]")
        for i, end in enumerate(self.times[1:-1]):
            if t <= end or near(end):
                return i
        return len(self.pieces) - 1

    def at_time(self, t):
        """The piece that holds at time t, as a FunctionOfSpaceTime."""
        return self.pieces[self.piece(t)]

    def __call__(self, coords, t, component=None):
        """The piece's value at (coords, t), (...): one component, as the
        reference's."""
        return self.at_time(t)(coords, t, component=0)

    def on_device(self, coords: torch.Tensor, t, component=0):
        """``FunctionOfSpaceTime.on_device`` of the piece that holds at t
        (a number; ``DirichletHandler.rates`` differentiates the piece
        itself, from ``at_time``)."""
        return self.at_time(t).on_device(coords, t, component)


class FunctionManager:
    """FUNCT table by positive integer id; id 0 / None means constant 1.
    A spec ``{"multifunction": {"times": [...], "pieces": [...]}}`` is a
    ``MultiFunctionOfTime``."""

    def __init__(self):
        self._funcs: dict[int, FunctionOfSpaceTime] = {}

    def add(self, fid: int, spec):
        if isinstance(spec, dict):
            if set(spec) != {"multifunction"}:
                raise NotImplementedError(
                    f"functions.{fid}: {sorted(spec)} is not ported "
                    f"(expressions of x, y, z, t and multifunction are)")
            mf = spec["multifunction"]
            self._funcs[int(fid)] = MultiFunctionOfTime(
                mf["times"], mf["pieces"], name=f"FUNCT {fid}")
            return
        self._funcs[int(fid)] = FunctionOfSpaceTime.from_spec(spec)

    def get(self, fid) -> FunctionOfSpaceTime:
        if fid in (None, 0, "none"):
            return FunctionOfSpaceTime([SymbolicExpression("1")])
        return self._funcs[int(fid)]

    def __contains__(self, fid):
        return int(fid) in self._funcs
