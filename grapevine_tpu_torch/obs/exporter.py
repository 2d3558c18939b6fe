"""Prometheus text exposition (format version 0.0.4) of a registry (a
copy of ``grapevine_tpu/obs/exporter.py``).

Stdlib-only on purpose: the container policy bakes no prometheus_client,
and the text format is small enough that owning it is cheaper than
gating a dependency. Histograms render cumulative ``_bucket`` series
with ``le`` edges fixed at registration, plus ``_sum``/``_count``.
"""

from __future__ import annotations

import math

from .registry import TelemetryRegistry


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def _escape_help(text: str) -> str:
    """# HELP escaping per the 0.0.4 text format: backslash and line
    feed (a raw newline would terminate the comment mid-text and turn
    the remainder into an unparseable sample line)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(value: str) -> str:
    """Label-value escaping per the 0.0.4 text format: backslash,
    double-quote, and line feed. Label values are registration-declared
    (obs/registry.py), so this is belt-and-braces — but a declared value
    containing a quote must still scrape clean, not corrupt the series
    name for every metric after it."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _labelstr(keys, vals, extra=()) -> str:
    pairs = [f'{k}="{_escape_label_value(v)}"' for k, v in zip(keys, vals)]
    pairs += [f'{k}="{_escape_label_value(v)}"' for k, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render_prometheus(registry: TelemetryRegistry) -> str:
    lines: list[str] = []
    for m in registry.collect():
        lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for vals, child in m.series():
            if m.kind == "histogram":
                # one locked state() read: cumulative buckets, +Inf, sum
                # and count must come from the same instant or a racing
                # observe() renders a torn histogram
                counts, total, count = child.state()
                acc = 0
                for edge, c in zip(m.buckets, counts):
                    acc += c
                    ls = _labelstr(
                        m.label_keys, vals, [("le", _fmt_value(edge))]
                    )
                    lines.append(f"{m.name}_bucket{ls} {acc}")
                ls = _labelstr(m.label_keys, vals, [("le", "+Inf")])
                lines.append(f"{m.name}_bucket{ls} {count}")
                ls = _labelstr(m.label_keys, vals)
                lines.append(f"{m.name}_sum{ls} {_fmt_value(total)}")
                lines.append(f"{m.name}_count{ls} {count}")
            else:
                ls = _labelstr(m.label_keys, vals)
                lines.append(f"{m.name}{ls} {_fmt_value(child.value)}")
    return "\n".join(lines) + "\n"
