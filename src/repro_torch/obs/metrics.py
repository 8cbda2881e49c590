"""Dependency-free serving metrics: labeled Counters, Gauges, and
Histograms in a registry with Prometheus text exposition and JSONL
snapshot export.

Design points:

* **Pow2 buckets.**  Histogram bucket bounds default to powers of two —
  the same bucketing discipline the engine applies to every shape before
  dispatch (`next_power_of_2` on token counts / context lens), so a
  latency histogram's buckets line up with the executable buckets whose
  launches fill them.
* **Bounded label cardinality.**  Each metric family caps the number of
  distinct label-sets it will materialize (`max_series`); series beyond
  the cap are DROPPED and counted (`family.dropped`,
  `registry.dropped_series`) instead of growing without bound — a
  misbehaving label (e.g. a request id) degrades to a counter of dropped
  series, never to an OOM.
* **Two export paths.**  `render_prometheus()` emits the Prometheus text
  exposition format (`# HELP` / `# TYPE`, `_bucket{le=...}` with
  cumulative counts, `_sum`, `_count`); `snapshot()` returns a pure-JSON
  dict (one line per call via `write_jsonl`) whose round trip is exact —
  the bench trajectory and the telemetry→autotune refit loop both consume
  it.

The registry is engine-thread-local by design (the serving loop is a
single host thread); there is deliberately no locking.  The one
concurrent READER is the scrape thread (`obs.server`): exports iterate
materialized copies (`sorted(...)`, `list(...)`) of the family/series
dicts, which the GIL makes safe against the engine's inserts — a scrape
racing a step can observe a histogram whose `sum` is one observation
ahead of a bucket count, never a crash.
"""
from __future__ import annotations

import bisect
import json
import math
import re


def pow2_buckets(lo: float, hi: float) -> tuple[float, ...]:
    """Power-of-two bucket upper bounds from `lo` doubling to >= `hi`."""
    assert lo > 0 and hi >= lo, (lo, hi)
    out = [float(lo)]
    while out[-1] < hi:
        out.append(out[-1] * 2.0)
    return tuple(out)


# 1us .. 128s: covers a fused CPU test step and a cold graph capture alike
LATENCY_BUCKETS_S = pow2_buckets(1e-6, 128.0)
# 1 .. 64Ki token rows: the packed-step token-bucket range
TOKEN_BUCKETS = pow2_buckets(1.0, 65536.0)


def fmt_float(v: float) -> str:
    """Prometheus-style float rendering ('+Inf', no exponent surprises)."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(value: str) -> str:
    """Label-value escaping: backslash, double-quote, newline (in that
    order — backslash first so the others aren't double-escaped)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """HELP-text escaping: the exposition format escapes only backslash
    and newline there (quotes are legal verbatim)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _unescape(s: str) -> str:
    out, i = [], 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            out.append({"n": "\n", '"': '"', "\\": "\\"}
                       .get(s[i + 1], "\\" + s[i + 1]))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>.*)\})?'
    r' (?P<value>[+-]?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|Inf|NaN))$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> dict:
    """Parse exposition-format text back into
    ``{family: {"type","help","samples": [(name, labels, value)]}}``.

    Strict on sample-line syntax (raises ValueError on a malformed line)
    so it doubles as the conformance check in tests and the endpoint
    smoke; samples are filed under their family (``_bucket``/``_sum``/
    ``_count`` suffixes map back to the histogram's ``# TYPE`` name)."""
    fams: dict[str, dict] = {}
    last_typed = None
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_txt = rest.partition(" ")
            fams.setdefault(name, {"type": "untyped", "help": "",
                                   "samples": []})
            fams[name]["help"] = _unescape(help_txt)
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            fams.setdefault(name, {"type": "untyped", "help": "",
                                   "samples": []})
            fams[name]["type"] = kind.strip()
            last_typed = name
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed exposition sample line: {line!r}")
        name = m.group("name")
        raw = m.group("labels")
        labels = ({k: _unescape(v) for k, v in _LABEL_RE.findall(raw)}
                  if raw else {})
        value = float(m.group("value").replace("Inf", "inf"))
        fam = name
        if (last_typed and fams.get(last_typed, {}).get("type") == "histogram"
                and name in (f"{last_typed}_bucket", f"{last_typed}_sum",
                             f"{last_typed}_count")):
            fam = last_typed
        fams.setdefault(fam, {"type": "untyped", "help": "", "samples": []})
        fams[fam]["samples"].append((name, labels, value))
    return fams


class _Family:
    """Shared series bookkeeping for one named metric family."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames, max_series: int,
                 registry: "Registry"):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_series = max_series
        self.dropped = 0
        self._registry = registry
        self._series: dict[tuple, object] = {}

    def _key(self, labels: dict) -> tuple | None:
        """Label dict -> series key; None when dropped by the cap."""
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.labelnames)}")
        key = tuple(str(labels[n]) for n in self.labelnames)
        if key not in self._series and len(self._series) >= self.max_series:
            self.dropped += 1
            self._registry.dropped_series += 1
            return None
        return key

    def _label_dict(self, key: tuple) -> dict:
        return dict(zip(self.labelnames, key))

    def __len__(self) -> int:
        return len(self._series)


class Counter(_Family):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        assert amount >= 0, f"counter {self.name} cannot decrease"
        key = self._key(labels)
        if key is not None:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._series.get(
            tuple(str(labels[n]) for n in self.labelnames), 0.0)


class Gauge(_Family):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        if key is not None:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        if key is not None:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        return self._series.get(
            tuple(str(labels[n]) for n in self.labelnames), 0.0)


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, help, labelnames, max_series, registry,
                 buckets=None):
        super().__init__(name, help, labelnames, max_series, registry)
        bounds = tuple(sorted(buckets)) if buckets else LATENCY_BUCKETS_S
        assert len(set(bounds)) == len(bounds), "duplicate bucket bounds"
        self.buckets = bounds

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        if key is None:
            return
        h = self._series.get(key)
        if h is None:
            # counts[i] = observations in (buckets[i-1], buckets[i]];
            # counts[-1] = overflow (> buckets[-1], i.e. the +Inf bucket)
            h = {"counts": [0] * (len(self.buckets) + 1),
                 "sum": 0.0, "count": 0}
            self._series[key] = h
        h["counts"][bisect.bisect_left(self.buckets, value)] += 1
        h["sum"] += float(value)
        h["count"] += 1

    def get(self, **labels) -> dict | None:
        """{'sum','count','buckets': {le-bound: CUMULATIVE count}} or None."""
        h = self._series.get(
            tuple(str(labels[n]) for n in self.labelnames))
        if h is None:
            return None
        cum, out = 0, {}
        for bound, n in zip(self.buckets, h["counts"]):
            cum += n
            out[fmt_float(bound)] = cum
        out["+Inf"] = cum + h["counts"][-1]
        return {"sum": h["sum"], "count": h["count"], "buckets": out}

    def quantile(self, q: float, **labels) -> float | None:
        """Bucket-interpolated quantile (the PromQL histogram_quantile
        analog); None with no observations.  Overflow observations clamp
        to the largest finite bound."""
        h = self._series.get(
            tuple(str(labels[n]) for n in self.labelnames))
        if h is None or h["count"] == 0:
            return None
        rank = q * h["count"]
        cum = 0
        for i, n in enumerate(h["counts"][:-1]):
            cum += n
            if cum >= rank and n:
                hi = self.buckets[i]
                lo = self.buckets[i - 1] if i else 0.0
                return lo + (hi - lo) * (1 - (cum - rank) / n)
        return self.buckets[-1]


class Registry:
    """Create-or-get factory and exporter for metric families."""

    def __init__(self, max_series_per_family: int = 512):
        self.max_series_per_family = max_series_per_family
        self.dropped_series = 0
        self._families: dict[str, _Family] = {}

    def _get(self, cls, name: str, help: str, labelnames, **kw) -> _Family:
        fam = self._families.get(name)
        if fam is not None:
            if type(fam) is not cls or fam.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} re-registered as {cls.kind} with "
                    f"labels {tuple(labelnames)} (was {fam.kind} "
                    f"{fam.labelnames})")
            return fam
        fam = cls(name, help, labelnames, self.max_series_per_family,
                  self, **kw)
        self._families[name] = fam
        return fam

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=None) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    def families(self) -> dict[str, _Family]:
        return dict(self._families)

    def value(self, name: str, **labels) -> float | None:
        """Counter/gauge series value (None: family unknown)."""
        fam = self._families.get(name)
        if fam is None:
            return None
        assert isinstance(fam, (Counter, Gauge)), f"{name} is a {fam.kind}"
        return fam.value(**labels)

    # -- exports -----------------------------------------------------------

    def snapshot(self) -> dict:
        """Pure-JSON state dump; `snapshot -> json -> snapshot` is exact."""
        out = {}
        for name, fam in sorted(self._families.items()):
            series = []
            for key in sorted(fam._series):
                if isinstance(fam, Histogram):
                    entry = fam.get(**fam._label_dict(key))
                    entry["labels"] = fam._label_dict(key)
                else:
                    entry = {"labels": fam._label_dict(key),
                             "value": fam._series[key]}
                series.append(entry)
            out[name] = {"type": fam.kind, "help": fam.help,
                         "labelnames": list(fam.labelnames),
                         "dropped_series": fam.dropped, "series": series}
        return out

    def write_jsonl(self, path: str, **meta) -> None:
        """Append one snapshot line: {"meta": {...}, "metrics": {...}}."""
        with open(path, "a") as f:
            f.write(json.dumps({"meta": meta, "metrics": self.snapshot()},
                               sort_keys=True) + "\n")

    @staticmethod
    def read_jsonl(path: str) -> list[dict]:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        lines = []
        for name, fam in sorted(self._families.items()):
            if fam.help:
                lines.append(f"# HELP {name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key in sorted(fam._series):
                labels = fam._label_dict(key)
                if isinstance(fam, Histogram):
                    h = fam.get(**labels)
                    for le, cum in h["buckets"].items():
                        lines.append(
                            f"{name}_bucket"
                            f"{_render_labels({**labels, 'le': le})} {cum}")
                    lines.append(f"{name}_sum{_render_labels(labels)} "
                                 f"{fmt_float(h['sum'])}")
                    lines.append(f"{name}_count{_render_labels(labels)} "
                                 f"{h['count']}")
                else:
                    lines.append(f"{name}{_render_labels(labels)} "
                                 f"{fmt_float(fam._series[key])}")
        return "\n".join(lines) + "\n"


def _render_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels.items())
    return "{" + inner + "}"
