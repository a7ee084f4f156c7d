"""Log / config / time-file parsers for evaluation pipelines.

Counterpart of ``wembed_tpu/eval/parsers.py``: a re-implementation of the
reference's ConfigParser and TimeParser
(reference: src/evaluationLib/src/metrics/ConfigParser.cpp:9-72,
TimeParser.cpp:8-25): scrape ``> name=value`` lines from an embedder log,
read a two-line CSV config, or read a single wall-time line.
"""

from __future__ import annotations

import re

# the reference's embedderRegex (ConfigParser.hpp:22)
_EMBEDDER_LINE = re.compile(r"> ([^()=]+)(\(default\))?=(.*)")


def parse_wembed_log(path: str) -> dict[str, str]:
    """Extract '> name=value' (or '> name(default)=value') config lines."""
    out: dict[str, str] = {}
    with open(path) as f:
        for line in f:
            m = _EMBEDDER_LINE.match(line.rstrip("\n"))
            if m:
                out[m.group(1)] = m.group(3)
    return out


def parse_csv_config(path: str) -> dict[str, str]:
    """Two-line CSV: header row of names + one row of values
    (ConfigParser.cpp LogType::CSV)."""
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    if len(lines) < 2:
        raise ValueError(f"CSV config {path!r} needs a header and a value row")
    names = lines[0].split(",")
    values = lines[1].split(",")
    return dict(zip(names, values))


def parse_time_file(path: str) -> str:
    """Single wall-time line (TimeParser.cpp:8-25)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if len(lines) != 1:
        raise ValueError("Time file should contain only one line")
    return lines[0]
