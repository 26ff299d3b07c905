"""Gate-count profiling of circuit construction.

Twin of reference plonky2/src/util/context_tree.rs:1-140 (`ContextTree` +
`with_context!`): a hierarchy of named scopes, each recording how many gate
rows were added while it was open.  Use via `CircuitBuilder.context(...)`:

    with builder.context("verify FRI proof"):
        ...

and print with `builder.print_context_tree()`.
"""

from __future__ import annotations

from contextlib import contextmanager


class ContextTree:
    def __init__(self, name: str = "root", enter_gate_count: int = 0):
        self.name = name
        self.enter_gate_count = enter_gate_count
        self.exit_gate_count: int | None = None
        self.children: list[ContextTree] = []

    def gate_count(self) -> int:
        assert self.exit_gate_count is not None
        return self.exit_gate_count - self.enter_gate_count

    def lines(self, min_gates: int = 1, depth: int = 0) -> list:
        out = []
        if self.exit_gate_count is not None and self.gate_count() >= min_gates:
            out.append(f"{'  ' * depth}{self.gate_count():>8} gates  {self.name}")
        for c in self.children:
            out.extend(c.lines(min_gates, depth + 1))
        return out


class ContextTracker:
    """Mixin-style helper owned by the builder."""

    def __init__(self):
        self.root = ContextTree()
        self._stack = [self.root]

    @contextmanager
    def scope(self, name: str, gate_count_fn):
        node = ContextTree(name, gate_count_fn())
        self._stack[-1].children.append(node)
        self._stack.append(node)
        try:
            yield node
        finally:
            node.exit_gate_count = gate_count_fn()
            self._stack.pop()

    def report(self, total_gates: int, min_gates: int = 1) -> str:
        self.root.exit_gate_count = total_gates
        return "\n".join(self.root.lines(min_gates))
