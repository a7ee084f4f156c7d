"""The span-window growth protocol around the embedding loop.

Counterpart of ``SpanGrowthMixin`` in ``wembed_tpu/core/span_driver.py``.
The reference's radius index is exact and never truncates
(WeightedIndex.cpp:65-100); the span windows can, and the protocol keeps
them covering:

  * PRESIZE (construction, ``set_coordinates``, ``set_weights``): measure
    every window's need at the current positions, grow until nothing
    overflows (at most 6 rounds), then resize every window to its need.
  * GROWTH: the loop stops at the first step that reports overflow; the
    starved windows grow from freshly measured needs and the loop resumes.
    When the needs call the windows covered, the overflow is stale (the
    positions moved one step since the overflowing sweep): resume without
    growth up to 3 times in a row, then widen every live window by one tile
    (``grow_all``).  ``_MAX_GROWTH_EVENTS`` stops a runaway.
  * SHRINK: the loop also pauses at every multiple of
    ``span_resize_interval`` iterations; after a segment without growth,
    over-provisioned windows shrink to their needs.

Needs always come from the structures build on the embedder's device (the
JAX package's device-measured branch), for presize too: the same
projection axes as the sweep, so no host mirror can disagree with it.

The embedder provides ``_index``, ``_state``, ``opts``, ``verbose``,
``_growth_events``, ``_span_structures()`` (the structures at the current
positions) and ``_swap_index(index)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_MAX_GROWTH_EVENTS = 200  # runaway guard only; coverage ends growth (can_grow)
_MAX_STALE_RESUMES = 3


class SpanGrowthMixin:
    _spurious_resumes = 0

    def _measure_needs(self) -> tuple[np.ndarray, int]:
        """(NB, R) window needs and the overflow of the current windows, at
        the current positions, from the device build."""
        s = self._span_structures()
        return s.need.cpu().numpy().astype(np.int64), int(s.overflow)

    def _presize_spans(self) -> None:
        """Size the windows for the current positions before stepping, so a
        run starts untruncated (windows starve most at spread-out starts)."""
        if self._index is None:
            return
        needs = None
        for _ in range(6):
            needs, overflow = self._measure_needs()
            if overflow == 0:
                break
            grown = self._index.grow_from_needs(needs)
            if grown is None:
                break
            self._swap_index(grown)
        if needs is not None:
            # two-sided: the initial heuristic over-provisions most windows
            resized = self._index.resize_to_needs(needs)
            if resized is not None:
                self._swap_index(resized)

    def _grow_spans(self) -> bool:
        """Widen truncated windows; True if the loop should resume (windows
        grew, or the overflow is stale)."""
        if self._growth_events >= _MAX_GROWTH_EVENTS or not self._index.can_grow():
            return False
        needs, _ = self._measure_needs()
        grown = self._index.grow_from_needs(needs, headroom=1.5)
        if grown is None:
            # measured on the sweep's own axes, "covered" means the current
            # windows fit the current positions: the overflow is one step old
            self._spurious_resumes += 1
            if self._spurious_resumes <= _MAX_STALE_RESUMES:
                return True
            grown = self._index.grow_all(needs)
        if grown is None:
            return False
        self._growth_events += 1
        self._swap_index(grown)
        return True

    def _announce_growth(self, overflow: int) -> None:
        if self.verbose:
            print(
                f"(growing candidate spans after overflow {overflow}; "
                f"event {self._growth_events})"
            )

    def _maybe_shrink_spans(self) -> None:
        shrunk = self._index.shrink_to_needs(self._measure_needs()[0])
        if shrunk is not None:
            self._shrink_events += 1
            self._swap_index(shrunk)

    def _drive_span_loop(self, run_segment, cap: int) -> None:
        """calculateEmbedding on the span path: ``run_segment(iter_cap,
        stop_on_overflow)`` steps until ``iter_cap``, convergence or (with
        ``stop_on_overflow``) the first overflowing step.  Once growth can
        do no more, the loop runs on to convergence under the residual
        truncation."""
        stop_on_overflow = True
        interval = int(self.opts.span_resize_interval or 0)
        seg_growth = 0  # growth events since the last segment boundary
        while True:
            it_now = self._state.iteration
            # boundaries at global multiples of the interval, so that short
            # segmented calls still cross them
            seg_cap = min(cap, (it_now // interval + 1) * interval) if interval > 0 else cap
            run_segment(seg_cap, stop_on_overflow)
            if self._state.iteration >= cap:
                break
            overflow = int(self._state.overflow)
            if overflow == 0:
                self._spurious_resumes = 0
                if float(self._state.pos_change) < self.opts.position_min_change:
                    break  # converged, no truncation
                # shrink only after a growth-free segment: while needs still
                # rise, trimming to the current need starves windows again
                if seg_growth == 0:
                    self._maybe_shrink_spans()
                seg_growth = 0
                continue
            if self._grow_spans():
                seg_growth += 1
                self._announce_growth(overflow)
            else:
                if not stop_on_overflow:
                    break  # converged under residual truncation
                stop_on_overflow = False
            # at least one more step under the new windows
            self._state = dataclasses.replace(
                self._state,
                pos_change=torch.full_like(self._state.pos_change, float("inf")),
                overflow=torch.zeros_like(self._state.overflow),
            )
