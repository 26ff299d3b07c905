"""Hierarchical wall-clock scopes (twin of reference util/timing.rs:8).

Usage:
    timing = TimingTree("prove", device)
    with timing.scope("compute wire polynomials"):
        ...
    timing.close()
    timing.as_dict()

torch runs CUDA work asynchronously, so a tree made for a CUDA device calls
``torch.cuda.synchronize`` as each scope ends: a scope then holds the device
time of its own work.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


def block(device) -> None:
    """Wait for the device's queued work (a no-op for the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class TimingTree:
    def __init__(self, name: str = "root", device="cpu"):
        self.name = name
        self.device = device
        self.start = time.perf_counter()
        self.end = None
        self.children: list[TimingTree] = []
        self._stack = [self]

    @contextmanager
    def scope(self, name: str):
        node = TimingTree(name, self.device)
        self._stack[-1].children.append(node)
        self._stack.append(node)
        try:
            yield node
        finally:
            block(self.device)
            node.end = time.perf_counter()
            self._stack.pop()

    def close(self):
        if self.end is None:
            block(self.device)
            self.end = time.perf_counter()

    def duration(self) -> float:
        end = self.end if self.end is not None else time.perf_counter()
        return end - self.start

    def lines(self, depth: int = 0):
        yield f"{'  ' * depth}{self.duration()*1e3:9.3f}ms  {self.name}"
        for c in self.children:
            yield from c.lines(depth + 1)

    def print(self):
        self.close()
        for line in self.lines():
            print(line)

    def as_dict(self):
        return {
            "name": self.name,
            "ms": self.duration() * 1e3,
            "children": [c.as_dict() for c in self.children],
        }
