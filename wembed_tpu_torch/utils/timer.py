"""Hierarchical phase timer.

Counterpart of ``wembed_tpu/utils/timer.py`` and the reference's
util::Timer (reference: src/utilLib/include/Timings.hpp:25-57,
src/utilLib/src/Timings.cpp:9-78): a stack of named phases accumulating a
tree of (depth, display name, seconds).  A phase opened with a CUDA
``device`` synchronises that device before it stops, so the time covers
the kernels the phase enqueued and not only their launch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


@dataclass
class TimingResult:
    """One row of the hierarchical breakdown (reference include/wembed.h:37-41)."""

    depth: int
    display_name: str
    value: float  # seconds


@dataclass
class _Node:
    key: str
    display_name: str
    value: float = 0.0
    children: list["_Node"] = field(default_factory=list)
    _index: dict[str, "_Node"] = field(default_factory=dict)

    def child(self, key: str, display_name: str) -> "_Node":
        node = self._index.get(key)
        if node is None:
            node = _Node(key, display_name)
            self.children.append(node)
            self._index[key] = node
        return node


class Timer:
    """Stack-based accumulating phase timer.

    ``start(key)`` pushes a phase; ``stop(key)`` pops it and accumulates the
    elapsed wall time into the tree node addressed by the current stack.
    Mirrors util::Timer::startTiming/stopTiming (Timings.cpp:9-47).
    """

    def __init__(self) -> None:
        self._root = _Node("", "")
        self._stack: list[tuple[_Node, float]] = []

    def start(self, key: str, display_name: str | None = None) -> None:
        parent = self._stack[-1][0] if self._stack else self._root
        node = parent.child(key, display_name or key)
        self._stack.append((node, time.perf_counter()))

    def stop(self, key: str, device: torch.device | None = None) -> None:
        """Close phase ``key``; with a CUDA ``device``, wait for its queue first."""
        if not self._stack:
            raise RuntimeError(f"Timer.stop({key!r}) with empty phase stack")
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        node, t0 = self._stack.pop()
        if node.key != key:
            raise RuntimeError(f"Timer.stop({key!r}) does not match open phase {node.key!r}")
        node.value += time.perf_counter() - t0

    class _Phase:
        def __init__(self, timer: "Timer", key: str, display_name, device):
            self._timer, self._key = timer, key
            self._display_name, self._device = display_name, device

        def __enter__(self):
            self._timer.start(self._key, self._display_name)

        def __exit__(self, *exc):
            self._timer.stop(self._key, self._device)
            return False

    def phase(
        self,
        key: str,
        display_name: str | None = None,
        device: torch.device | None = None,
    ) -> "_Phase":
        return Timer._Phase(self, key, display_name, device)

    def results(self) -> list[TimingResult]:
        """Depth-first flattening, matching getHierarchicalTimingResults."""
        out: list[TimingResult] = []

        def visit(node: _Node, depth: int) -> None:
            out.append(TimingResult(depth, node.display_name, node.value))
            for c in node.children:
                visit(c, depth + 1)

        for c in self._root.children:
            visit(c, 0)
        return out


def timings_to_string(timings: list[TimingResult]) -> str:
    """Pretty-print the tree (reference Timings.cpp:65-78 /
    wembed::timingsToString)."""
    lines = []
    for t in timings:
        lines.append(f"{'  ' * t.depth}{t.display_name}: {t.value:.6f}s")
    return "\n".join(lines)
