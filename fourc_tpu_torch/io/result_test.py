"""RESULT DESCRIPTION regression checks.

Counterpart of fourc_tpu/io/result_test.py (the reference's ResultTest
harness): each deck carries expected nodal values with per-line
tolerances, checked in-process after the time loop.

Deck syntax:
  result_description:
    - {field: structure, node: 6, quantity: dispx, value: 1.789..., tolerance: 1e-12}
    - {field: structure, special: true, quantity: newton_iters, value: 5, tolerance: 0}
"""

from __future__ import annotations

import re
from dataclasses import dataclass

# a node line as ``TestResult`` prints it
NODE_LINE = re.compile(r"^\[(?:OK  |FAIL)\] \S+ node (\d+) (\S+): "
                       r"actual=(\S+) expected=(\S+) tol=(\S+)$", re.M)


@dataclass
class TestResult:
    desc: dict
    actual: float
    expected: float
    tolerance: float

    @property
    def ok(self) -> bool:
        return abs(self.actual - self.expected) <= self.tolerance

    def __str__(self):
        mark = "OK  " if self.ok else "FAIL"
        d = self.desc
        where = f"special {d['quantity']}" if d.get("special") else f"node {d.get('node')} {d['quantity']}"
        return (
            f"[{mark}] {d.get('field','structure')} {where}: "
            f"actual={self.actual:.16g} expected={self.expected:.16g} tol={self.tolerance:g}"
        )


def read_node_lines(out: str) -> dict:
    """(node, quantity) -> (actual, expected, tolerance) of every node line
    printed in ``out``."""
    return {(int(m[0]), m[1]): tuple(float(x) for x in m[2:])
            for m in NODE_LINE.findall(out)}


def run_result_tests(tests: list, run_result) -> list[TestResult]:
    """run_result: physics.driver.RunResult (has .query(field, quantity, node))."""
    out = []
    for t in tests:
        t = dict(t)
        fieldname = t.get("field", None)
        if t.get("special"):
            actual = run_result.query_special(fieldname, t["quantity"])
        else:
            actual = run_result.query(fieldname, t["quantity"], int(t["node"]))
        out.append(
            TestResult(
                desc=t,
                actual=float(actual),
                expected=float(t["value"]),
                tolerance=float(t["tolerance"]),
            )
        )
    return out


def assert_result_tests(tests, run_result, verbose=True):
    results = run_result_tests(tests, run_result)
    msgs = [str(r) for r in results]
    if verbose:
        for m in msgs:
            print(m)
    failures = [m for r, m in zip(results, msgs) if not r.ok]
    if failures:
        raise AssertionError("result tests failed:\n" + "\n".join(failures))
    return results
